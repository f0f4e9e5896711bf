/* A scripted C host of the C ABI (reference train/demo/demo_trainer.cc and
 * inference/capi's demos): it reads commands from a plan file and drives
 * PD_* calls, the way a serving binary or a C++ trainer embeds the
 * framework. It builds against paddle_tpu_capi.h alone, so the same
 * source links the port's libpaddle_tpu_capi.so or any other library of
 * the same ABI. paddle_tpu_torch/testing/capi_client.py builds and runs it.
 *
 *   pd_client PLAN
 *
 * One command a line, words split on spaces:
 *   py CODE...            run the rest of the line as Python (the embedded
 *                         interpreter, initialized here first if needed)
 *   lib                   print "lib PATH": the library PD_NewPredictor
 *                         came from
 *   predictor PREFIX [KEYHEX]
 *                         PD_NewPredictor; "predictor ok" or
 *                         "predictor error MESSAGE"
 *   trainer ARTIFACT      PD_NewTrainer; "trainer ok" / "trainer error ..."
 *   input DTYPE FILE NDIM D0 D1 ...
 *                         append an input read from FILE (PD_DTYPE_* code)
 *   clear                 drop the inputs
 *   run N OUTFILE         N PD_PredictorRun calls; "run ms X" (mean ms a
 *                         run); the last run's outputs to OUTFILE: int32
 *                         count, then per output int32 ndim, int64 dims,
 *                         float32 data
 *   step N                N PD_TrainerRunStep calls; "loss HEXFLOAT" each,
 *                         then "step ms X" (mean ms a step)
 *   save PATH             PD_TrainerSave; "save ok" / "save error ..."
 * Exits 0 when every command ran; a failed PD_* call prints its error and
 * exits 1.
 */
#define _GNU_SOURCE
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <dlfcn.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "paddle_tpu_capi.h"

#define MAX_INPUTS 16
#define MAX_DIMS 8

static void* bufs[MAX_INPUTS];
static int dtypes[MAX_INPUTS];
static int64_t dims[MAX_INPUTS][MAX_DIMS];
static const int64_t* shapes[MAX_INPUTS];
static int ndims[MAX_INPUTS];
static int n_in = 0;

static double now_ms(void) {
  struct timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return t.tv_sec * 1e3 + t.tv_nsec / 1e6;
}

static void ensure_py(void) {
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    PyEval_SaveThread();
  }
}

static void clear_inputs(void) {
  for (int i = 0; i < n_in; i++) free(bufs[i]);
  n_in = 0;
}

static int add_input(char* args) {
  int dtype = atoi(strtok(args, " "));
  char* path = strtok(NULL, " ");
  int nd = atoi(strtok(NULL, " "));
  if (n_in >= MAX_INPUTS || nd > MAX_DIMS) return 1;
  int64_t numel = 1;
  for (int d = 0; d < nd; d++) {
    dims[n_in][d] = atoll(strtok(NULL, " "));
    numel *= dims[n_in][d];
  }
  size_t item = dtype == PD_DTYPE_INT64 ? 8 : 4;
  void* buf = malloc((size_t)numel * item + 1);
  FILE* f = fopen(path, "rb");
  if (!f || fread(buf, item, (size_t)numel, f) != (size_t)numel) {
    fprintf(stderr, "pd_client: cannot read %s\n", path);
    if (f) fclose(f);
    free(buf);
    return 1;
  }
  fclose(f);
  bufs[n_in] = buf;
  dtypes[n_in] = dtype;
  shapes[n_in] = dims[n_in];
  ndims[n_in] = nd;
  n_in++;
  return 0;
}

static int write_outputs(PD_Predictor* p, const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return 1;
  int32_t n = PD_PredictorNumOutputs(p);
  fwrite(&n, 4, 1, f);
  for (int i = 0; i < n; i++) {
    const float* data;
    const int64_t* shape;
    int nd;
    if (PD_PredictorOutput(p, i, &data, &shape, &nd)) {
      fclose(f);
      return 1;
    }
    int32_t nd32 = nd;
    int64_t numel = 1;
    fwrite(&nd32, 4, 1, f);
    for (int d = 0; d < nd; d++) {
      fwrite(&shape[d], 8, 1, f);
      numel *= shape[d];
    }
    fwrite(data, 4, (size_t)numel, f);
  }
  fclose(f);
  return 0;
}

int main(int argc, char** argv) {
  if (argc != 2) {
    fprintf(stderr, "usage: pd_client PLAN\n");
    return 2;
  }
  FILE* plan = fopen(argv[1], "r");
  if (!plan) {
    fprintf(stderr, "pd_client: cannot open %s\n", argv[1]);
    return 2;
  }
  PD_Predictor* pred = NULL;
  PD_Trainer* trainer = NULL;
  static char line[1 << 16];
  int rc = 0;
  while (rc == 0 && fgets(line, sizeof line, plan)) {
    line[strcspn(line, "\r\n")] = 0;
    char* rest = strchr(line, ' ');
    if (rest) *rest++ = 0;
    else rest = line + strlen(line);
    if (!strcmp(line, "py")) {
      ensure_py();
      PyGILState_STATE g = PyGILState_Ensure();
      rc = PyRun_SimpleString(rest) ? 1 : 0;
      PyRun_SimpleString("import sys; sys.stdout.flush()");
      PyGILState_Release(g);
    } else if (!strcmp(line, "lib")) {
      Dl_info info;
      rc = !dladdr((void*)&PD_NewPredictor, &info);
      if (!rc) printf("lib %s\n", info.dli_fname);
    } else if (!strcmp(line, "predictor")) {
      char* prefix = strtok(rest, " ");
      char* key = strtok(NULL, " ");
      if (pred) PD_DeletePredictor(pred);
      pred = PD_NewPredictor(prefix, key);
      if (pred) printf("predictor ok\n");
      else printf("predictor error %s\n", PD_GetLastError());
    } else if (!strcmp(line, "trainer")) {
      if (trainer) PD_DeleteTrainer(trainer);
      trainer = PD_NewTrainer(rest);
      if (trainer) printf("trainer ok\n");
      else printf("trainer error %s\n", PD_GetLastError());
    } else if (!strcmp(line, "input")) {
      rc = add_input(rest);
    } else if (!strcmp(line, "clear")) {
      clear_inputs();
    } else if (!strcmp(line, "run")) {
      int n = atoi(strtok(rest, " "));
      char* out = strtok(NULL, " ");
      double t = now_ms();
      for (int i = 0; i < n && rc == 0; i++) {
        if (PD_PredictorRun(pred, (const void* const*)bufs, dtypes, shapes,
                            ndims, n_in)) {
          printf("run error %s\n", PD_GetLastError());
          rc = 1;
        }
      }
      if (rc == 0) {
        printf("run ms %.6f\n", (now_ms() - t) / n);
        rc = write_outputs(pred, out);
      }
    } else if (!strcmp(line, "step")) {
      int n = atoi(rest);
      double total = 0;
      for (int i = 0; i < n && rc == 0; i++) {
        float loss;
        double t = now_ms();
        if (PD_TrainerRunStep(trainer, (const void* const*)bufs, dtypes,
                              shapes, ndims, n_in, &loss)) {
          printf("step error %s\n", PD_GetLastError());
          rc = 1;
        } else {
          total += now_ms() - t;
          printf("loss %a\n", (double)loss);
        }
      }
      if (rc == 0) printf("step ms %.6f\n", total / n);
    } else if (!strcmp(line, "save")) {
      if (PD_TrainerSave(trainer, rest)) {
        printf("save error %s\n", PD_GetLastError());
        rc = 1;
      } else {
        printf("save ok\n");
      }
    } else if (line[0]) {
      fprintf(stderr, "pd_client: unknown command %s\n", line);
      rc = 2;
    }
    fflush(stdout);
  }
  fclose(plan);
  clear_inputs();
  if (pred) PD_DeletePredictor(pred);
  if (trainer) PD_DeleteTrainer(trainer);
  return rc;
}
