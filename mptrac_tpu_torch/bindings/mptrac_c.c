/* C API implementation: embeds CPython, drives mptrac_tpu_torch.capi
 * (the PyTorch/CUDA package).  See mptrac_c.h for the contract.
 * Built at first use by mptrac_tpu_torch.capi.build_shim(). */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdio.h>

#include "mptrac_c.h"

static PyObject *capi_mod = NULL;

static int err(const char *where) {
  fprintf(stderr, "mptrac_c: error in %s\n", where);
  if (PyErr_Occurred())
    PyErr_Print();
  return -1;
}

int mptrac_c_start(void) {
  if (capi_mod)
    return 0;
  if (!Py_IsInitialized())
    Py_Initialize();
  /* Make the repo importable when the caller runs from elsewhere:
   * MPTRAC_TPU_ROOT names the directory that holds mptrac_tpu_torch. */
  PyRun_SimpleString(
      "import os, sys\n"
      "here = os.environ.get('MPTRAC_TPU_ROOT')\n"
      "if here and here not in sys.path:\n"
      "    sys.path.insert(0, here)\n");
  capi_mod = PyImport_ImportModule("mptrac_tpu_torch.capi");
  if (!capi_mod)
    return err("start/import mptrac_tpu_torch.capi");
  return 0;
}

void mptrac_c_finish(void) {
  Py_XDECREF(capi_mod);
  capi_mod = NULL;
  if (Py_IsInitialized())
    Py_FinalizeEx();
}

static long call_long(PyObject *res, const char *where) {
  if (!res)
    return err(where);
  long v = PyLong_AsLong(res);
  Py_DECREF(res);
  if (v == -1 && PyErr_Occurred())
    return err(where);
  return v;
}

static double call_double(PyObject *res, const char *where) {
  if (!res) {
    err(where);
    return -1.0;
  }
  double v = PyFloat_AsDouble(res);
  Py_DECREF(res);
  if (v == -1.0 && PyErr_Occurred()) {
    err(where);
    return -1.0;
  }
  return v;
}

int mptrac_c_create(const char *dirname, const char *ctl_file,
                    const char *atm_file, int nargs,
                    const char **args) {
  if (!capi_mod && mptrac_c_start() < 0)
    return -1;
  PyObject *lst = PyList_New(nargs);
  for (int i = 0; i < nargs; i++)
    PyList_SetItem(lst, i, PyUnicode_FromString(args[i]));
  PyObject *res = PyObject_CallMethod(capi_mod, "create", "sssO",
                                      dirname, ctl_file, atm_file, lst);
  Py_DECREF(lst);
  return (int) call_long(res, "create");
}

double mptrac_c_t_start(int handle) {
  return call_double(PyObject_CallMethod(capi_mod, "t_start", "i",
                                         handle), "t_start");
}

double mptrac_c_t_stop(int handle) {
  return call_double(PyObject_CallMethod(capi_mod, "t_stop", "i",
                                         handle), "t_stop");
}

double mptrac_c_time(int handle) {
  return call_double(PyObject_CallMethod(capi_mod, "time", "i", handle),
                     "time");
}

int mptrac_c_step(int handle, int write_output) {
  return (int) call_long(PyObject_CallMethod(capi_mod, "step", "ii",
                                             handle, write_output),
                         "step");
}

int mptrac_c_run(int handle, int write_output) {
  return (int) call_long(PyObject_CallMethod(capi_mod, "run", "ii",
                                             handle, write_output),
                         "run");
}

int mptrac_c_n_parcels(int handle) {
  return (int) call_long(PyObject_CallMethod(capi_mod, "n_parcels", "i",
                                             handle), "n_parcels");
}

int mptrac_c_get_positions(int handle, double *lon, double *lat,
                           double *p, int cap) {
  return (int) call_long(
      PyObject_CallMethod(capi_mod, "get_positions", "iLLLi", handle,
                          (long long) (uintptr_t) lon,
                          (long long) (uintptr_t) lat,
                          (long long) (uintptr_t) p, cap),
      "get_positions");
}

int mptrac_c_write_atm(int handle, const char *path) {
  return (int) call_long(PyObject_CallMethod(capi_mod, "write_atm",
                                             "is", handle, path),
                         "write_atm");
}

int mptrac_c_destroy(int handle) {
  return (int) call_long(PyObject_CallMethod(capi_mod, "destroy", "i",
                                             handle), "destroy");
}
