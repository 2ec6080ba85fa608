/*
 * _iqio — native sample-I/O runtime for opv_tpu.
 *
 * The reference modem's runtime layer is C++ (stdio stream plumbing,
 * opv-mod.cpp:304-309 / opv-demod.cpp:1022-1026); this is the
 * framework's native equivalent: zero-copy int16-interleaved IQ <->
 * complex64/float conversion and a blocking exact-count fd reader, exposed
 * through the CPython C API (no pybind11 dependency).
 *
 * Hot paths served:
 *   - streaming CLI ingest: bytes -> complex64 ndarray (demod feed)
 *   - TX egress: int16 ndarray pairs -> wire bytes (already contiguous)
 *   - read_exact(fd, n): assemble exactly n bytes from a pipe/socket
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <errno.h>
#include <stdint.h>
#include <string.h>
#include <unistd.h>

/* bytes (int16 LE interleaved I,Q) -> bytes of complex64 (float32 I + jQ).
 * Returned as a bytes object the caller wraps with
 * np.frombuffer(..., dtype=np.complex64) — avoids a numpy C-API dependency
 * while still doing the convert loop at native speed. */
static PyObject *iq_to_c64(PyObject *self, PyObject *args) {
  Py_buffer in;
  if (!PyArg_ParseTuple(args, "y*", &in)) return NULL;
  Py_ssize_t npairs = in.len / 4; /* 2 x int16 per sample */
  PyObject *out = PyBytes_FromStringAndSize(NULL, npairs * 8);
  if (!out) {
    PyBuffer_Release(&in);
    return NULL;
  }
  const int16_t *src = (const int16_t *)in.buf;
  float *dst = (float *)PyBytes_AS_STRING(out);
  Py_BEGIN_ALLOW_THREADS
  for (Py_ssize_t i = 0; i < npairs; ++i) {
    dst[2 * i] = (float)src[2 * i];
    dst[2 * i + 1] = (float)src[2 * i + 1];
  }
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&in);
  return out;
}

/* bytes of float32 (I,Q interleaved, already scaled) -> int16 LE wire bytes,
 * truncating toward zero like the reference's static_cast<int16_t>. */
static PyObject *f32_to_iq(PyObject *self, PyObject *args) {
  Py_buffer in;
  if (!PyArg_ParseTuple(args, "y*", &in)) return NULL;
  Py_ssize_t n = in.len / 4;
  PyObject *out = PyBytes_FromStringAndSize(NULL, n * 2);
  if (!out) {
    PyBuffer_Release(&in);
    return NULL;
  }
  const float *src = (const float *)in.buf;
  int16_t *dst = (int16_t *)PyBytes_AS_STRING(out);
  Py_BEGIN_ALLOW_THREADS
  for (Py_ssize_t i = 0; i < n; ++i) {
    float v = src[i];
    if (v > 32767.0f) v = 32767.0f;
    if (v < -32768.0f) v = -32768.0f;
    dst[i] = (int16_t)v; /* C cast truncates toward zero */
  }
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&in);
  return out;
}

/* read_exact(fd, n) -> bytes of length <= n (short only at EOF). */
static PyObject *read_exact(PyObject *self, PyObject *args) {
  int fd;
  Py_ssize_t want;
  if (!PyArg_ParseTuple(args, "in", &fd, &want)) return NULL;
  PyObject *out = PyBytes_FromStringAndSize(NULL, want);
  if (!out) return NULL;
  char *buf = PyBytes_AS_STRING(out);
  Py_ssize_t got = 0;
  int err = 0;
  int interrupted = 0;
  while (got < want) {
    ssize_t r;
    Py_BEGIN_ALLOW_THREADS
    r = read(fd, buf + got, (size_t)(want - got));
    Py_END_ALLOW_THREADS
    if (r < 0) {
      if (errno == EINTR) {
        /* PEP 475: run Python signal handlers (Ctrl+C must interrupt a
         * blocked read) before retrying */
        if (PyErr_CheckSignals() != 0) {
          interrupted = 1;
          break;
        }
        continue;
      }
      err = errno;
      break;
    }
    if (r == 0) break; /* EOF */
    got += r;
  }
  if (interrupted) {
    Py_DECREF(out);
    return NULL;
  }
  if (err) {
    Py_DECREF(out);
    errno = err;
    return PyErr_SetFromErrno(PyExc_OSError);
  }
  if (got < want && _PyBytes_Resize(&out, got) < 0) return NULL;
  return out;
}

static PyMethodDef methods[] = {
    {"iq_to_c64", iq_to_c64, METH_VARARGS,
     "int16-interleaved IQ bytes -> complex64 raw bytes"},
    {"f32_to_iq", f32_to_iq, METH_VARARGS,
     "float32 interleaved bytes -> int16 wire bytes (truncate toward zero)"},
    {"read_exact", read_exact, METH_VARARGS,
     "read exactly n bytes from fd (short read only at EOF)"},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef mod = {PyModuleDef_HEAD_INIT, "_iqio",
                                 "native IQ sample I/O runtime", -1, methods};

PyMODINIT_FUNC PyInit__iqio(void) { return PyModule_Create(&mod); }
