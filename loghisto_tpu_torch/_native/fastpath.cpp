// CPython fast-path extension for per-call ingest (the port's own copy
// of loghisto_tpu/_native/fastpath.cpp, with its own module and capsule
// names so that both packages' extensions load in one process).
//
// The ctypes path costs ~1-2us per call (fine for batches, terrible per
// sample); this METH_FASTCALL extension gets one (metric_id, value)
// append down to ~100ns — the per-call analog of the reference's hot
// loop, feeding the same drain -> vectorized-compress pipeline.
//
// API (module loghisto_torch_fastpath):
//   buf = create(capacity)                  # capsule
//   record(buf, metric_id, value)           # shed-don't-block when full
//   ids_bytes, vals_bytes, dropped = drain(buf)   # dropped is LIFETIME-
//                                                 # cumulative, not per-drain
//   n = size(buf)

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <ctime>

#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

constexpr const char* kCapsuleName = "loghisto_torch.FastBuf";

struct FastBuf {
  std::mutex mu;
  std::vector<int32_t> ids;
  std::vector<double> vals;
  int64_t cap = 0;
  uint64_t dropped = 0;
};

FastBuf* get_buf(PyObject* capsule) {
  return static_cast<FastBuf*>(
      PyCapsule_GetPointer(capsule, kCapsuleName));
}

// Single stage-or-shed policy shared by record() and timer_stop(): cap
// check, int32 id cast, drop accounting — one place to change.
inline int64_t stage_sample(FastBuf* fb, long id, double v) {
  std::lock_guard<std::mutex> lock(fb->mu);
  if (static_cast<int64_t>(fb->ids.size()) < fb->cap) {
    fb->ids.push_back(static_cast<int32_t>(id));
    fb->vals.push_back(v);
  } else {
    ++fb->dropped;
  }
  return static_cast<int64_t>(fb->ids.size());
}

void destroy_buf(PyObject* capsule) {
  delete static_cast<FastBuf*>(
      PyCapsule_GetPointer(capsule, kCapsuleName));
}

PyObject* fb_create(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  if (nargs != 1) {
    PyErr_SetString(PyExc_TypeError, "create(capacity)");
    return nullptr;
  }
  long long cap = PyLong_AsLongLong(args[0]);
  if (cap <= 0) {
    if (!PyErr_Occurred())
      PyErr_SetString(PyExc_ValueError, "capacity must be positive");
    return nullptr;
  }
  FastBuf* fb = new (std::nothrow) FastBuf();
  if (!fb) return PyErr_NoMemory();
  fb->cap = cap;
  int64_t warm = cap < (1 << 20) ? cap : (1 << 20);
  fb->ids.reserve(static_cast<size_t>(warm));
  fb->vals.reserve(static_cast<size_t>(warm));
  return PyCapsule_New(fb, kCapsuleName, destroy_buf);
}

PyObject* fb_record(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  if (nargs != 3) {
    PyErr_SetString(PyExc_TypeError, "record(buf, metric_id, value)");
    return nullptr;
  }
  FastBuf* fb = get_buf(args[0]);
  if (!fb) return nullptr;
  long id = PyLong_AsLong(args[1]);
  if (id == -1 && PyErr_Occurred()) return nullptr;
  double v = PyFloat_AsDouble(args[2]);
  if (v == -1.0 && PyErr_Occurred()) return nullptr;
  stage_sample(fb, id, v);
  Py_RETURN_NONE;
}

// record_sized: like record(), but returns the post-stage buffer size so
// a per-name bound recorder can do its fold check with one int compare
// instead of the Python-side thread-local stride machinery.
PyObject* fb_record_sized(PyObject*, PyObject* const* args,
                          Py_ssize_t nargs) {
  if (nargs != 3) {
    PyErr_SetString(PyExc_TypeError, "record_sized(buf, metric_id, value)");
    return nullptr;
  }
  FastBuf* fb = get_buf(args[0]);
  if (!fb) return nullptr;
  long id = PyLong_AsLong(args[1]);
  if (id == -1 && PyErr_Occurred()) return nullptr;
  double v = PyFloat_AsDouble(args[2]);
  if (v == -1.0 && PyErr_Occurred()) return nullptr;
  return PyLong_FromLongLong(stage_sample(fb, id, v));
}

PyObject* fb_drain(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  if (nargs != 1) {
    PyErr_SetString(PyExc_TypeError, "drain(buf)");
    return nullptr;
  }
  FastBuf* fb = get_buf(args[0]);
  if (!fb) return nullptr;
  std::vector<int32_t> ids;
  std::vector<double> vals;
  uint64_t dropped;
  {
    std::lock_guard<std::mutex> lock(fb->mu);
    ids.swap(fb->ids);
    vals.swap(fb->vals);
    dropped = fb->dropped;
    size_t warm = ids.capacity() < static_cast<size_t>(fb->cap)
                      ? ids.capacity()
                      : static_cast<size_t>(fb->cap);
    fb->ids.reserve(warm);
    fb->vals.reserve(warm);
  }
  PyObject* ids_bytes = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(ids.data()),
      static_cast<Py_ssize_t>(ids.size() * sizeof(int32_t)));
  if (!ids_bytes) return nullptr;
  PyObject* vals_bytes = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(vals.data()),
      static_cast<Py_ssize_t>(vals.size() * sizeof(double)));
  if (!vals_bytes) {
    Py_DECREF(ids_bytes);
    return nullptr;
  }
  PyObject* out = Py_BuildValue("(NNK)", ids_bytes, vals_bytes,
                                static_cast<unsigned long long>(dropped));
  return out;
}

inline int64_t monotonic_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<int64_t>(ts.tv_sec) * 1000000000LL + ts.tv_nsec;
}

// C timer pair: the reference's timer loop measures the gap between
// StartTimer's and Stop's clock reads.
// Here the clock read is the LAST operation before timer_start returns
// and the FIRST operation when timer_stop enters — everything Python
// does between the two calls (boxing the stamp, storing it, the call
// plumbing) is what the measured distribution reports, and nothing
// else rides inside it.
PyObject* fb_timer_start(PyObject*, PyObject* const*, Py_ssize_t nargs) {
  if (nargs != 0) {
    PyErr_SetString(PyExc_TypeError, "timer_start()");
    return nullptr;
  }
  return PyLong_FromLongLong(monotonic_ns());
}

// timer_stop(buf, metric_id, start_ns) -> (duration_ns, staged_size);
// the clock is read FIRST (before arg parsing), staging happens after
// the gap closes, and the post-stage size rides back in the same call
// so the caller's fold check is one int compare — no separate size()
// call, no stride bookkeeping.
PyObject* fb_timer_stop(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  const int64_t now = monotonic_ns();
  if (nargs != 3) {
    PyErr_SetString(PyExc_TypeError, "timer_stop(buf, metric_id, start_ns)");
    return nullptr;
  }
  FastBuf* fb = get_buf(args[0]);
  if (!fb) return nullptr;
  long id = PyLong_AsLong(args[1]);
  if (id == -1 && PyErr_Occurred()) return nullptr;
  long long start = PyLong_AsLongLong(args[2]);
  if (start == -1 && PyErr_Occurred()) return nullptr;
  const int64_t dur = now - static_cast<int64_t>(start);
  const int64_t size = stage_sample(fb, id, static_cast<double>(dur));
  PyObject* out = PyTuple_New(2);
  if (!out) return nullptr;
  PyObject* d = PyLong_FromLongLong(dur);
  PyObject* s = PyLong_FromLongLong(size);
  if (!d || !s) {
    Py_XDECREF(d);
    Py_XDECREF(s);
    Py_DECREF(out);
    return nullptr;
  }
  PyTuple_SET_ITEM(out, 0, d);
  PyTuple_SET_ITEM(out, 1, s);
  return out;
}

PyObject* fb_size(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  if (nargs != 1) {
    PyErr_SetString(PyExc_TypeError, "size(buf)");
    return nullptr;
  }
  FastBuf* fb = get_buf(args[0]);
  if (!fb) return nullptr;
  std::lock_guard<std::mutex> lock(fb->mu);
  return PyLong_FromSsize_t(static_cast<Py_ssize_t>(fb->ids.size()));
}

PyMethodDef kMethods[] = {
    {"create", reinterpret_cast<PyCFunction>(fb_create), METH_FASTCALL,
     "create(capacity) -> buffer capsule"},
    {"record", reinterpret_cast<PyCFunction>(fb_record), METH_FASTCALL,
     "record(buf, metric_id, value)"},
    {"record_sized", reinterpret_cast<PyCFunction>(fb_record_sized),
     METH_FASTCALL,
     "record_sized(buf, metric_id, value) -> staged size after append"},
    {"drain", reinterpret_cast<PyCFunction>(fb_drain), METH_FASTCALL,
     "drain(buf) -> (ids_bytes, values_bytes, dropped)"},
    {"size", reinterpret_cast<PyCFunction>(fb_size), METH_FASTCALL,
     "size(buf) -> staged sample count"},
    {"timer_start", reinterpret_cast<PyCFunction>(fb_timer_start),
     METH_FASTCALL, "timer_start() -> monotonic ns stamp"},
    {"timer_stop", reinterpret_cast<PyCFunction>(fb_timer_stop),
     METH_FASTCALL,
     "timer_stop(buf, metric_id, start_ns) -> (duration ns, staged size)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "loghisto_torch_fastpath",
    "Per-call ingest fast path (C extension).", -1, kMethods,
};

}  // namespace

PyMODINIT_FUNC PyInit_loghisto_torch_fastpath(void) {
  return PyModule_Create(&kModule);
}
