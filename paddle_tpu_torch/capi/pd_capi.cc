// C inference API implementation (counterpart of
// paddle_tpu/capi/pd_capi.cc): a thin extern-"C" shell around an embedded
// CPython interpreter running paddle_tpu_torch.capi.bridge.
//
// Reference analog: paddle/fluid/inference/capi_exp/pd_predictor.cc wraps
// the C++ AnalysisPredictor; here the "runtime" is the Python-hosted
// Predictor whose hot path is one cached compiled program, so the C
// layer only marshals buffers (ctypes pointer-in, bytes-out) and never
// touches tensor math. All Python access is GIL-guarded so callers may
// invoke from any (single) thread.
#include "pd_capi.h"

#include <Python.h>

#include <cstring>
#include <string>

namespace {

PyObject* g_bridge = nullptr;     // paddle_tpu_torch.capi.bridge module
thread_local std::string g_err = "";

void capture_py_error(const char* where) {
  PyObject *type = nullptr, *value = nullptr, *trace = nullptr;
  PyErr_Fetch(&type, &value, &trace);
  PyErr_NormalizeException(&type, &value, &trace);
  std::string msg = std::string(where) + ": ";
  if (value != nullptr) {
    PyObject* s = PyObject_Str(value);
    if (s != nullptr) {
      const char* c = PyUnicode_AsUTF8(s);
      msg += (c != nullptr) ? c : "<unprintable>";
      Py_DECREF(s);
    }
  } else {
    msg += "unknown error";
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(trace);
  g_err = msg;
}

class Gil {
 public:
  Gil() : state_(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

// Call a bridge function; returns new reference or nullptr (error set).
PyObject* bridge_call(const char* fn, PyObject* args) {
  if (args == nullptr) {
    // a failed Py_BuildValue at the call site: surface the REAL Python
    // error instead of calling the bridge with zero args and reporting
    // the resulting misleading TypeError
    capture_py_error(fn);
    return nullptr;
  }
  if (g_bridge == nullptr) {
    g_err = "PD_Init has not been called";
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject* f = PyObject_GetAttrString(g_bridge, fn);
  if (f == nullptr) {
    capture_py_error(fn);
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject* out = PyObject_CallObject(f, args);
  Py_DECREF(f);
  Py_XDECREF(args);
  if (out == nullptr) capture_py_error(fn);
  return out;
}

}  // namespace

struct PD_Config {
  std::string model_dir;
  std::string device = "gpu";
};

struct PD_Predictor {
  long handle;
};

extern "C" {

int PD_Init(const char* repo_root) {
  if (g_bridge != nullptr) return 0;
  bool we_initialized = false;
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);  // no signal handlers: the host app owns them
    we_initialized = true;
  }
  int rc = 0;
  {
    Gil gil;
    if (repo_root != nullptr && repo_root[0] != '\0') {
      PyObject* path = PySys_GetObject("path");  // borrowed
      PyObject* root = PyUnicode_FromString(repo_root);
      if (path != nullptr && root != nullptr) {
        PyList_Insert(path, 0, root);
      }
      Py_XDECREF(root);
    }
    PyObject* mod = PyImport_ImportModule("paddle_tpu_torch.capi.bridge");
    if (mod == nullptr) {
      capture_py_error("import paddle_tpu_torch.capi.bridge");
      rc = -1;
    } else {
      g_bridge = mod;  // keep the reference for the process lifetime
    }
  }
  if (we_initialized) {
    // Py_InitializeEx left this thread holding the GIL; release it so
    // later calls (from this OR another thread) can PyGILState_Ensure
    // without deadlocking — the header's serialized-callers contract
    PyEval_SaveThread();
  }
  return rc;
}

namespace {

// Every entry point must refuse before touching the GIL machinery: a
// PyGILState_Ensure on an uninitialized interpreter aborts the process
// instead of returning the documented error.
bool pd_ready(const char* where) {
  if (g_bridge != nullptr && Py_IsInitialized()) return true;
  g_err = std::string(where) + ": PD_Init has not been called";
  return false;
}

}  // namespace

const char* PD_GetLastError(void) { return g_err.c_str(); }

PD_Config* PD_ConfigCreate(void) { return new PD_Config(); }

void PD_ConfigSetModel(PD_Config* config, const char* model_dir) {
  if (config != nullptr && model_dir != nullptr) {
    config->model_dir = model_dir;
  }
}

void PD_ConfigSetDevice(PD_Config* config, const char* device) {
  if (config != nullptr && device != nullptr) {
    config->device = device;
  }
}

void PD_ConfigDestroy(PD_Config* config) { delete config; }

PD_Predictor* PD_PredictorCreate(const PD_Config* config) {
  if (config == nullptr || config->model_dir.empty()) {
    g_err = "PD_PredictorCreate: config with a model path is required";
    return nullptr;
  }
  if (!pd_ready("PD_PredictorCreate")) return nullptr;
  Gil gil;
  PyObject* out = bridge_call(
      "create", Py_BuildValue("(ss)", config->model_dir.c_str(),
                              config->device.c_str()));
  if (out == nullptr) return nullptr;
  long h = PyLong_AsLong(out);
  Py_DECREF(out);
  if (h < 0) {
    g_err = "PD_PredictorCreate: bridge returned an invalid handle";
    return nullptr;
  }
  PD_Predictor* p = new PD_Predictor();
  p->handle = h;
  return p;
}

int PD_PredictorGetInputNum(const PD_Predictor* predictor) {
  if (predictor == nullptr || !pd_ready("PD_PredictorGetInputNum"))
    return -1;
  Gil gil;
  PyObject* out =
      bridge_call("input_num", Py_BuildValue("(l)", predictor->handle));
  if (out == nullptr) return -1;
  long n = PyLong_AsLong(out);
  Py_DECREF(out);
  return static_cast<int>(n);
}

int PD_PredictorGetInputName(const PD_Predictor* predictor, int idx,
                             char* buf, int cap) {
  if (predictor == nullptr || buf == nullptr || cap <= 0 ||
      !pd_ready("PD_PredictorGetInputName"))
    return -1;
  Gil gil;
  PyObject* out = bridge_call(
      "input_name", Py_BuildValue("(li)", predictor->handle, idx));
  if (out == nullptr) return -1;
  const char* name = PyUnicode_AsUTF8(out);
  if (name == nullptr) {
    capture_py_error("input_name");
    Py_DECREF(out);
    return -1;
  }
  int full = static_cast<int>(strlen(name));
  snprintf(buf, cap, "%s", name);
  Py_DECREF(out);
  return full;
}

int PD_PredictorSetInputFloat(PD_Predictor* predictor, const char* name,
                              const float* data, const int64_t* shape,
                              int ndim) {
  if (predictor == nullptr || name == nullptr || data == nullptr ||
      shape == nullptr || ndim < 0) {
    g_err = "PD_PredictorSetInputFloat: null argument";
    return -1;
  }
  if (!pd_ready("PD_PredictorSetInputFloat")) return -1;
  Gil gil;
  PyObject* dims = PyTuple_New(ndim);
  if (dims == nullptr) {
    capture_py_error("PD_PredictorSetInputFloat");
    return -1;
  }
  for (int i = 0; i < ndim; ++i) {
    PyObject* d = PyLong_FromLongLong(shape[i]);
    if (d == nullptr) {
      capture_py_error("PD_PredictorSetInputFloat");
      Py_DECREF(dims);
      return -1;
    }
    PyTuple_SET_ITEM(dims, i, d);
  }
  // "O" (not "N"): we keep our reference and drop it ourselves, so a
  // Py_BuildValue failure cannot leak the dims tuple
  PyObject* args =
      Py_BuildValue("(lsKO)", predictor->handle, name,
                    (unsigned long long)(uintptr_t)data, dims);
  Py_DECREF(dims);
  PyObject* out = bridge_call("set_input_f32", args);
  if (out == nullptr) return -1;
  Py_DECREF(out);
  return 0;
}

int PD_PredictorRun(PD_Predictor* predictor) {
  if (predictor == nullptr || !pd_ready("PD_PredictorRun")) return -1;
  Gil gil;
  PyObject* out =
      bridge_call("run", Py_BuildValue("(l)", predictor->handle));
  if (out == nullptr) return -1;
  Py_DECREF(out);
  return 0;
}

int PD_PredictorGetOutputNum(const PD_Predictor* predictor) {
  if (predictor == nullptr || !pd_ready("PD_PredictorGetOutputNum"))
    return -1;
  Gil gil;
  PyObject* out =
      bridge_call("output_num", Py_BuildValue("(l)", predictor->handle));
  if (out == nullptr) return -1;
  long n = PyLong_AsLong(out);
  Py_DECREF(out);
  return static_cast<int>(n);
}

int PD_PredictorGetOutputShape(const PD_Predictor* predictor, int idx,
                               int64_t* shape, int cap) {
  if (predictor == nullptr || shape == nullptr ||
      !pd_ready("PD_PredictorGetOutputShape"))
    return -1;
  Gil gil;
  PyObject* out = bridge_call(
      "output_shape", Py_BuildValue("(li)", predictor->handle, idx));
  if (out == nullptr) return -1;
  if (!PyTuple_Check(out)) {
    g_err = "output_shape: bridge returned a non-tuple";
    Py_DECREF(out);
    return -1;
  }
  int rank = static_cast<int>(PyTuple_GET_SIZE(out));
  for (int i = 0; i < rank && i < cap; ++i) {
    shape[i] = PyLong_AsLongLong(PyTuple_GET_ITEM(out, i));
  }
  Py_DECREF(out);
  return rank;
}

int64_t PD_PredictorGetOutputFloat(const PD_Predictor* predictor, int idx,
                                   float* buf, int64_t cap) {
  if (predictor == nullptr || buf == nullptr || cap < 0 ||
      !pd_ready("PD_PredictorGetOutputFloat"))
    return -1;
  Gil gil;
  PyObject* out = bridge_call(
      "output_bytes_f32", Py_BuildValue("(li)", predictor->handle, idx));
  if (out == nullptr) return -1;
  char* raw = nullptr;
  Py_ssize_t nbytes = 0;
  if (PyBytes_AsStringAndSize(out, &raw, &nbytes) != 0) {
    capture_py_error("output_bytes_f32");
    Py_DECREF(out);
    return -1;
  }
  int64_t count = nbytes / static_cast<int64_t>(sizeof(float));
  int64_t ncopy = count < cap ? count : cap;
  memcpy(buf, raw, ncopy * sizeof(float));
  Py_DECREF(out);
  return count;
}

void PD_PredictorDestroy(PD_Predictor* predictor) {
  if (predictor == nullptr) return;
  if (g_bridge != nullptr && Py_IsInitialized()) {
    Gil gil;
    PyObject* out =
        bridge_call("destroy", Py_BuildValue("(l)", predictor->handle));
    Py_XDECREF(out);
  }
  delete predictor;
}

}  // extern "C"
