/* paddle_tpu_torch C-ABI predictor and trainer.
 *
 * The reference ships C (inference/capi/), Go (go/paddle/predictor.go)
 * and R clients over its C++ AnalysisPredictor. This header is the same
 * C surface as the JAX package's (paddle_tpu/_native/include/
 * paddle_tpu_capi.h): the same functions, types, argument lists, dtype
 * codes and ownership rules, so the Go and R clients link against the
 * port's libpaddle_tpu_capi.so unchanged. Any language with a C FFI can
 * drive inference and training with it.
 *
 * Contract:
 *  - PD_NewPredictor loads a paddle_tpu_torch.jit.save (or
 *    paddle_tpu_torch.onnx.export) artifact by prefix ("model" ->
 *    model.pt2 + model.pdinfer.json), the torch.export program run by the
 *    port's inference.Predictor on the device the JSON names.
 *    cipher_key_hex may be "" or NULL; pass the AES key hex for a
 *    model.pt2.enc artifact.
 *  - Inputs are caller-owned buffers described by dtype/shape
 *    (PD_DTYPE_*); they are only read during PD_PredictorRun /
 *    PD_TrainerRunStep, which copy them before returning.
 *  - Outputs are library-owned f32 buffers, valid until the next
 *    PD_PredictorRun or PD_DeletePredictor on the same handle.
 *  - All functions return 0 on success (pointers: non-NULL); on failure
 *    PD_GetLastError() describes the problem.
 *  - The library embeds a Python runtime; the first PD_NewPredictor or
 *    PD_NewTrainer initializes it unless the host already did (set
 *    PYTHONPATH so paddle_tpu_torch and torch are importable). A host
 *    that wants the CPU initializes Python itself and calls
 *    paddle_tpu_torch.set_device("cpu") before its first PD_* call; the
 *    default device is the card.
 */
#ifndef PADDLE_TPU_CAPI_H_
#define PADDLE_TPU_CAPI_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct PD_Predictor PD_Predictor;

enum {
  PD_DTYPE_FLOAT32 = 0,
  PD_DTYPE_INT32 = 1,
  PD_DTYPE_INT64 = 2,
};

PD_Predictor* PD_NewPredictor(const char* model_prefix,
                              const char* cipher_key_hex);
void PD_DeletePredictor(PD_Predictor* predictor);

/* Run inference: n_in caller buffers, each with dtype code, rank
 * in_ndims[i] and dims in_shapes[i][0..ndim). Returns 0 on success. */
int PD_PredictorRun(PD_Predictor* predictor, const void* const* in_bufs,
                    const int* in_dtypes, const int64_t* const* in_shapes,
                    const int* in_ndims, int n_in);

int PD_PredictorNumOutputs(PD_Predictor* predictor);
/* Borrowed pointers into library-owned storage for output i. */
int PD_PredictorOutput(PD_Predictor* predictor, int i, const float** data,
                       const int64_t** shape, int* ndim);

const char* PD_GetLastError(void);

/* ---- C train API (reference train/demo/demo_trainer.cc) ----------------
 * A trainer loads an artifact written by
 * paddle_tpu_torch.static.capi_train.save_train_program (the training
 * Program's .pdmodel with its backward and optimizer sections, and the
 * .pdiparams state), or the JAX package's pickled artifact, and steps it
 * with caller-fed batches through the port's static Executor. */

typedef struct PD_Trainer PD_Trainer;

PD_Trainer* PD_NewTrainer(const char* artifact_path);
void PD_DeleteTrainer(PD_Trainer* trainer);
/* Feeds follow the program's data-var order; *loss receives the step's
 * loss mean. Returns 0 on success. */
int PD_TrainerRunStep(PD_Trainer* trainer, const void* const* in_bufs,
                      const int* in_dtypes,
                      const int64_t* const* in_shapes, const int* in_ndims,
                      int n_in, float* loss);
int PD_TrainerSave(PD_Trainer* trainer, const char* params_path);

#ifdef __cplusplus
}
#endif

#endif /* PADDLE_TPU_CAPI_H_ */
