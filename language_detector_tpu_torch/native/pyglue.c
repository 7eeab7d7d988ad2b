/* GIL-held CPython glue: list[str] -> UTF-8 blob + bounds in one pass.
 *
 * The Python-side marshalling for a 16K-doc batch (per-doc .encode()
 * producing 16K transient bytes objects, then b"".join copying them
 * again, then a cumsum over a length list) costs ~6ms of the
 * single-core host per batch. This fills the caller's blob and bounds
 * directly from each str's cached UTF-8 representation: one encode,
 * one copy, zero transient objects.
 *
 * Built as a SEPARATE shared object (build.sh -> libldtglue.so) so
 * libldtpack.so stays free of any libpython dependency — the C-ABI
 * detection seam must remain linkable from a cgo host with no Python
 * in the process. Loaded with ctypes.PyDLL (GIL held across the call:
 * every function here touches CPython API).
 *
 * Returns total bytes; -1 when the caller's blob is too small; -2 when
 * any element is not a str or is not encodable as strict UTF-8 (lone
 * surrogates — the Python caller falls back to its surrogatepass
 * path).
 */
#include <Python.h>

#include <stdint.h>
#include <string.h>

/* Contract version for the loader's staleness check (bump on any
 * signature/semantic change). */
int64_t ldt_glue_version(void) { return 1; }

int64_t ldt_blob_from_list(PyObject* list, int64_t n_expected,
                           uint8_t* blob, int64_t blob_cap,
                           int64_t* bounds) {
  if (!PyList_Check(list)) return -2;
  Py_ssize_t n = PyList_GET_SIZE(list);
  /* bounds was sized from an earlier len(texts); if another thread
   * mutated the list between the Python-side sizing and this call,
   * writing bounds[i+1] for a LONGER list would corrupt the heap. */
  if ((int64_t)n != n_expected) return -2;
  int64_t total = 0;
  bounds[0] = 0;
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject* s = PyList_GET_ITEM(list, i);
    if (!PyUnicode_Check(s)) return -2;
    Py_ssize_t sz;
    const char* p = PyUnicode_AsUTF8AndSize(s, &sz);
    if (p == NULL) {
      PyErr_Clear(); /* lone surrogate etc.: caller falls back */
      return -2;
    }
    if (blob != NULL) {
      if (total + (int64_t)sz > blob_cap) return -1;
      memcpy(blob + total, p, (size_t)sz);
    }
    total += (int64_t)sz;
    bounds[i + 1] = total;
  }
  return total;
}

/* Total UTF-8 bytes only (sizing pass; also warms each str's cached
 * utf8 so the fill pass is pure memcpy). Same error returns. */
int64_t ldt_blob_size(PyObject* list) {
  if (!PyList_Check(list)) return -2;
  Py_ssize_t n = PyList_GET_SIZE(list);
  int64_t total = 0;
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject* s = PyList_GET_ITEM(list, i);
    if (!PyUnicode_Check(s)) return -2;
    Py_ssize_t sz;
    if (PyUnicode_AsUTF8AndSize(s, &sz) == NULL) {
      PyErr_Clear();
      return -2;
    }
    total += (int64_t)sz;
  }
  return total;
}
