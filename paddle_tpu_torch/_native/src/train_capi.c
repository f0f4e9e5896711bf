/* C-ABI trainer over the port's static Executor (reference train/demo/
 * demo_trainer.cc and the fluid_train C++ API): load a saved training
 * Program, step it with caller-fed batches, persist its parameters, from
 * any C host, with no Python written at train time. It drives
 * paddle_tpu_torch.static.capi_train; same embedding as predictor_capi.c,
 * and both objects link into libpaddle_tpu_capi.so.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>

#include "../include/paddle_tpu_capi.h"

#define PD_CAPI_TRAIN "paddle_tpu_torch.static.capi_train"

/* shared with predictor_capi.c */
void pd_capi_set_err(const char* msg);
void pd_capi_set_err_from_py(void);
int pd_capi_ensure_python(void);
PyObject* pd_capi_inputs(const void* const* in_bufs, const int* in_dtypes,
                         const int64_t* const* in_shapes,
                         const int* in_ndims, int n_in);

struct PD_Trainer {
  PyObject* handle;   /* capi_train.create's handle */
};

PD_Trainer* PD_NewTrainer(const char* artifact_path) {
  pd_capi_ensure_python();
  PyGILState_STATE g = PyGILState_Ensure();
  PD_Trainer* t = NULL;
  PyObject* h = NULL;
  PyObject* mod = PyImport_ImportModule(PD_CAPI_TRAIN);
  if (!mod) {
    pd_capi_set_err_from_py();
    goto done;
  }
  h = PyObject_CallMethod(mod, "create", "s", artifact_path);
  if (!h) {
    pd_capi_set_err_from_py();
    goto done;
  }
  t = (PD_Trainer*)calloc(1, sizeof(PD_Trainer));
  t->handle = h;
done:
  Py_XDECREF(mod);
  PyGILState_Release(g);
  return t;
}

void PD_DeleteTrainer(PD_Trainer* t) {
  if (!t) return;
  PyGILState_STATE g = PyGILState_Ensure();
  Py_XDECREF(t->handle);
  PyGILState_Release(g);
  free(t);
}

/* One training step: feeds in the program's feed-name order. The loss
 * (the fetch's mean) is written to *loss. Returns 0 on success. */
int PD_TrainerRunStep(PD_Trainer* t, const void* const* in_bufs,
                      const int* in_dtypes,
                      const int64_t* const* in_shapes, const int* in_ndims,
                      int n_in, float* loss) {
  if (!t || !t->handle) {
    pd_capi_set_err("null trainer");
    return 1;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  int rc = 1;
  PyObject *mod = NULL, *inputs = NULL, *res = NULL;
  inputs = pd_capi_inputs(in_bufs, in_dtypes, in_shapes, in_ndims, n_in);
  if (!inputs) goto done;
  mod = PyImport_ImportModule(PD_CAPI_TRAIN);
  if (!mod) {
    pd_capi_set_err_from_py();
    goto done;
  }
  res = PyObject_CallMethod(mod, "run_step", "OO", t->handle, inputs);
  if (!res) {
    pd_capi_set_err_from_py();
    goto done;
  }
  *loss = (float)PyFloat_AsDouble(res);
  rc = 0;
done:
  Py_XDECREF(mod);
  Py_XDECREF(inputs);
  Py_XDECREF(res);
  PyGILState_Release(g);
  return rc;
}

int PD_TrainerSave(PD_Trainer* t, const char* path) {
  if (!t || !t->handle) {
    pd_capi_set_err("null trainer");
    return 1;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  int rc = 1;
  PyObject *mod = NULL, *res = NULL;
  mod = PyImport_ImportModule(PD_CAPI_TRAIN);
  if (!mod) {
    pd_capi_set_err_from_py();
    goto done;
  }
  res = PyObject_CallMethod(mod, "save_params", "Os", t->handle, path);
  if (!res) {
    pd_capi_set_err_from_py();
    goto done;
  }
  rc = 0;
done:
  Py_XDECREF(mod);
  Py_XDECREF(res);
  PyGILState_Release(g);
  return rc;
}
