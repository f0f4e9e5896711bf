/* C-ABI predictor over the port's inference.Predictor.
 *
 * Reference tier: paddle/fluid/inference/capi/ (pd_predictor.cc, C
 * wrappers over AnalysisPredictor). The library embeds CPython and drives
 * paddle_tpu_torch.inference.capi_bridge; the compute runs through the
 * port's torch.export program and its CUDA kernels, so this is a thin
 * marshalling layer, not a second runtime. Pure C, no pybind; built with
 * gcc by paddle_tpu_torch._native.build_capi() against Python.h and the
 * shared libpython.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "../include/paddle_tpu_capi.h"

#define PD_CAPI_BRIDGE "paddle_tpu_torch.inference.capi_bridge"

static char pd_err[4096];

struct PD_Predictor {
  PyObject* pred;           /* paddle_tpu_torch Predictor */
  PyObject* last_outputs;   /* list of (f32 array, shape) from the bridge */
  Py_buffer* views;         /* the arrays' buffers, held until cleared */
  int n_views;
  int n_out;
  int64_t* shapes;          /* flattened shape storage */
  int64_t** shape_ptrs;
  int* ndims;
};

const char* PD_GetLastError(void) { return pd_err; }

void pd_capi_set_err(const char* msg) {
  snprintf(pd_err, sizeof pd_err, "%s", msg);
}

void pd_capi_set_err_from_py(void) {
  PyObject *t = NULL, *v = NULL, *tb = NULL;
  PyErr_Fetch(&t, &v, &tb);
  PyObject* s = v ? PyObject_Str(v) : NULL;
  const char* c = s ? PyUnicode_AsUTF8(s) : NULL;
  pd_capi_set_err(c ? c : "unknown python error");
  Py_XDECREF(s);
  Py_XDECREF(t);
  Py_XDECREF(v);
  Py_XDECREF(tb);
}

int pd_capi_ensure_python(void) {
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    /* release the GIL acquired by initialization so PyGILState_Ensure
     * works from any caller thread */
    PyEval_SaveThread();
  }
  return 0;
}

PD_Predictor* PD_NewPredictor(const char* model_prefix,
                              const char* cipher_key_hex) {
  pd_capi_ensure_python();
  PyGILState_STATE g = PyGILState_Ensure();
  PD_Predictor* h = NULL;
  PyObject *mod = NULL, *pred = NULL;
  mod = PyImport_ImportModule(PD_CAPI_BRIDGE);
  if (!mod) {
    pd_capi_set_err_from_py();
    goto done;
  }
  pred = PyObject_CallMethod(mod, "create", "ss", model_prefix,
                             cipher_key_hex ? cipher_key_hex : "");
  if (!pred) {
    pd_capi_set_err_from_py();
    goto done;
  }
  h = (PD_Predictor*)calloc(1, sizeof(PD_Predictor));
  h->pred = pred;
  pred = NULL;
done:
  Py_XDECREF(mod);
  Py_XDECREF(pred);
  PyGILState_Release(g);
  return h;
}

static void pd_clear_outputs(PD_Predictor* h) {
  for (int i = 0; i < h->n_views; i++) PyBuffer_Release(&h->views[i]);
  free(h->views);
  h->views = NULL;
  h->n_views = 0;
  Py_XDECREF(h->last_outputs);
  h->last_outputs = NULL;
  free(h->shapes);
  free(h->shape_ptrs);
  free(h->ndims);
  h->shapes = NULL;
  h->shape_ptrs = NULL;
  h->ndims = NULL;
  h->n_out = 0;
}

void PD_DeletePredictor(PD_Predictor* h) {
  if (!h) return;
  PyGILState_STATE g = PyGILState_Ensure();
  pd_clear_outputs(h);
  Py_XDECREF(h->pred);
  PyGILState_Release(g);
  free(h);
}

static Py_ssize_t pd_dtype_size(int code) {
  switch (code) {
    case PD_DTYPE_FLOAT32:
    case PD_DTYPE_INT32:
      return 4;
    case PD_DTYPE_INT64:
      return 8;
  }
  return 0;
}

/* The caller's buffers as the bridge and capi_train.run_step take them: a
 * list of (memoryview over the buffer, dtype code, shape). NULL (with the
 * error set) on a bad dtype code. Called with the GIL held. */
PyObject* pd_capi_inputs(const void* const* in_bufs, const int* in_dtypes,
                         const int64_t* const* in_shapes,
                         const int* in_ndims, int n_in) {
  PyObject* inputs = PyList_New(n_in);
  for (int i = 0; i < n_in; i++) {
    Py_ssize_t itemsize = pd_dtype_size(in_dtypes[i]);
    if (itemsize == 0) {
      pd_capi_set_err("bad input dtype code");
      Py_DECREF(inputs);
      return NULL;
    }
    Py_ssize_t numel = 1;
    PyObject* shape = PyTuple_New(in_ndims[i]);
    for (int d = 0; d < in_ndims[i]; d++) {
      numel *= (Py_ssize_t)in_shapes[i][d];
      PyTuple_SET_ITEM(shape, d, PyLong_FromLongLong(in_shapes[i][d]));
    }
    PyObject* mv = PyMemoryView_FromMemory((char*)in_bufs[i],
                                           numel * itemsize, PyBUF_READ);
    PyObject* code = PyLong_FromLong(in_dtypes[i]);
    PyList_SET_ITEM(inputs, i, PyTuple_Pack(3, mv, code, shape));
    Py_DECREF(mv);
    Py_DECREF(code);
    Py_DECREF(shape);
  }
  return inputs;
}

int PD_PredictorRun(PD_Predictor* h, const void* const* in_bufs,
                    const int* in_dtypes, const int64_t* const* in_shapes,
                    const int* in_ndims, int n_in) {
  if (!h || !h->pred) {
    pd_capi_set_err("null predictor");
    return 1;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  int rc = 1;
  PyObject *mod = NULL, *inputs = NULL, *outs = NULL;
  pd_clear_outputs(h);
  inputs = pd_capi_inputs(in_bufs, in_dtypes, in_shapes, in_ndims, n_in);
  if (!inputs) goto done;
  mod = PyImport_ImportModule(PD_CAPI_BRIDGE);
  if (!mod) {
    pd_capi_set_err_from_py();
    goto done;
  }
  outs = PyObject_CallMethod(mod, "run", "OO", h->pred, inputs);
  if (!outs) {
    pd_capi_set_err_from_py();
    goto done;
  }
  h->n_out = (int)PyList_Size(outs);
  h->last_outputs = outs;
  outs = NULL;
  /* pre-extract shape tables */
  Py_ssize_t total_dims = 0;
  for (int i = 0; i < h->n_out; i++) {
    PyObject* shp = PyTuple_GetItem(PyList_GetItem(h->last_outputs, i), 1);
    total_dims += PyTuple_Size(shp);
  }
  h->shapes = (int64_t*)malloc(sizeof(int64_t) * (size_t)(total_dims + 1));
  h->shape_ptrs = (int64_t**)malloc(sizeof(int64_t*) * (size_t)h->n_out);
  h->ndims = (int*)malloc(sizeof(int) * (size_t)h->n_out);
  Py_ssize_t off = 0;
  for (int i = 0; i < h->n_out; i++) {
    PyObject* shp = PyTuple_GetItem(PyList_GetItem(h->last_outputs, i), 1);
    Py_ssize_t nd = PyTuple_Size(shp);
    h->shape_ptrs[i] = h->shapes + off;
    h->ndims[i] = (int)nd;
    for (Py_ssize_t d = 0; d < nd; d++) {
      h->shapes[off++] =
          (int64_t)PyLong_AsLongLong(PyTuple_GetItem(shp, d));
    }
  }
  /* the outputs' storage, read in place: no copy of the arrays */
  h->views = (Py_buffer*)calloc((size_t)h->n_out + 1, sizeof(Py_buffer));
  for (int i = 0; i < h->n_out; i++) {
    PyObject* arr = PyTuple_GetItem(PyList_GetItem(h->last_outputs, i), 0);
    if (PyObject_GetBuffer(arr, &h->views[i], PyBUF_C_CONTIGUOUS) != 0) {
      pd_capi_set_err_from_py();
      pd_clear_outputs(h);
      goto done;
    }
    h->n_views = i + 1;
  }
  rc = 0;
done:
  Py_XDECREF(mod);
  Py_XDECREF(inputs);
  Py_XDECREF(outs);
  PyGILState_Release(g);
  return rc;
}

int PD_PredictorNumOutputs(PD_Predictor* h) {
  return h ? h->n_out : -1;
}

int PD_PredictorOutput(PD_Predictor* h, int i, const float** data,
                       const int64_t** shape, int* ndim) {
  if (!h || !h->last_outputs || i < 0 || i >= h->n_out) {
    pd_capi_set_err("no such output (run first?)");
    return 1;
  }
  *data = (const float*)h->views[i].buf;
  *shape = h->shape_ptrs[i];
  *ndim = h->ndims[i];
  return 0;
}
