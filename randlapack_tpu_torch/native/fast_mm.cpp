// Fast MatrixMarket coordinate reader — the native IO tier
// (reference role: fast_matrix_market in benchmark/CMakeLists.txt:74-107
// and extras' .mtx ingestion). Single-pass mmap-free parser using
// std::from_chars; ~10x faster than scipy.io.mmread on large files.
//
// The PyTorch port's copy of the JAX package's native/fast_mm.cpp, built
// by randlapack_tpu_torch/_build.py (build_native: g++ into build/native/)
// and loaded by extras/io.py.
//
// Exposed as the CPython module `_randlapack_native`:
//   fast_mm_read(path)  -> (rows int32[], cols int32[], vals float64[], m, n)
//   fast_mm_write(path, rows, cols, vals, m, n) -> None
// Symmetric files are expanded to general (both triangles), matching
// scipy.io.mmread semantics. Pattern files get vals = 1.0. The writer
// emits coordinate/general with %.17g values (round-trip exact for f64).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

namespace {

struct Coo {
  std::vector<int32_t> rows, cols;
  std::vector<double> vals;
  long m = 0, n = 0;
};

const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

bool parse_file(const char* path, Coo& out, std::string& err) {
  FILE* f = std::fopen(path, "rb");
  if (!f) { err = "cannot open file"; return false; }
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string buf(static_cast<size_t>(size), '\0');
  if (std::fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
    std::fclose(f); err = "short read"; return false;
  }
  std::fclose(f);

  const char* p = buf.data();
  const char* end = p + buf.size();

  // header line
  bool symmetric = false, pattern = false;
  {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!nl) { err = "missing header"; return false; }
    std::string header(p, nl);
    if (header.rfind("%%MatrixMarket", 0) != 0) {
      err = "not a MatrixMarket file"; return false;
    }
    if (header.find("coordinate") == std::string::npos) {
      err = "only coordinate format supported"; return false;
    }
    symmetric = header.find("symmetric") != std::string::npos ||
                header.find("skew-symmetric") != std::string::npos ||
                header.find("hermitian") != std::string::npos;
    pattern = header.find("pattern") != std::string::npos;
    p = nl + 1;
  }
  // comments
  while (p < end && *p == '%') {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!nl) { err = "truncated comments"; return false; }
    p = nl + 1;
  }
  // size line
  long m = 0, n = 0, nnz = 0;
  {
    p = skip_ws(p, end);
    auto r1 = std::from_chars(p, end, m); p = skip_ws(r1.ptr, end);
    auto r2 = std::from_chars(p, end, n); p = skip_ws(r2.ptr, end);
    auto r3 = std::from_chars(p, end, nnz);
    if (r1.ec != std::errc() || r2.ec != std::errc() ||
        r3.ec != std::errc()) { err = "bad size line"; return false; }
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    p = nl ? nl + 1 : end;
  }
  out.m = m; out.n = n;
  size_t reserve = symmetric ? 2 * nnz : nnz;
  out.rows.reserve(reserve);
  out.cols.reserve(reserve);
  out.vals.reserve(reserve);

  for (long k = 0; k < nnz; ++k) {
    long i = 0, j = 0;
    double v = 1.0;
    p = skip_ws(p, end);
    auto r1 = std::from_chars(p, end, i);
    if (r1.ec != std::errc()) { err = "bad row index"; return false; }
    p = skip_ws(r1.ptr, end);
    auto r2 = std::from_chars(p, end, j);
    if (r2.ec != std::errc()) { err = "bad col index"; return false; }
    p = skip_ws(r2.ptr, end);
    if (!pattern) {
      auto r3 = std::from_chars(p, end, v);
      if (r3.ec != std::errc()) { err = "bad value"; return false; }
      p = r3.ptr;
    }
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    p = nl ? nl + 1 : end;
    out.rows.push_back(static_cast<int32_t>(i - 1));
    out.cols.push_back(static_cast<int32_t>(j - 1));
    out.vals.push_back(v);
    if (symmetric && i != j) {
      out.rows.push_back(static_cast<int32_t>(j - 1));
      out.cols.push_back(static_cast<int32_t>(i - 1));
      out.vals.push_back(v);
    }
  }
  return true;
}

PyObject* fast_mm_read(PyObject*, PyObject* args) {
  const char* path = nullptr;
  if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;

  Coo coo;
  std::string err;
  bool ok;
  Py_BEGIN_ALLOW_THREADS
  ok = parse_file(path, coo, err);
  Py_END_ALLOW_THREADS
  if (!ok) {
    PyErr_SetString(PyExc_ValueError, err.c_str());
    return nullptr;
  }

  npy_intp len = static_cast<npy_intp>(coo.rows.size());
  PyObject* rows = PyArray_SimpleNew(1, &len, NPY_INT32);
  PyObject* cols = PyArray_SimpleNew(1, &len, NPY_INT32);
  PyObject* vals = PyArray_SimpleNew(1, &len, NPY_FLOAT64);
  if (!rows || !cols || !vals) return nullptr;
  std::memcpy(PyArray_DATA(reinterpret_cast<PyArrayObject*>(rows)),
              coo.rows.data(), len * sizeof(int32_t));
  std::memcpy(PyArray_DATA(reinterpret_cast<PyArrayObject*>(cols)),
              coo.cols.data(), len * sizeof(int32_t));
  std::memcpy(PyArray_DATA(reinterpret_cast<PyArrayObject*>(vals)),
              coo.vals.data(), len * sizeof(double));
  return Py_BuildValue("(NNNll)", rows, cols, vals, coo.m, coo.n);
}

PyObject* fast_mm_write(PyObject*, PyObject* args) {
  const char* path = nullptr;
  PyObject *rows_o, *cols_o, *vals_o;
  long m, n;
  if (!PyArg_ParseTuple(args, "sOOOll", &path, &rows_o, &cols_o, &vals_o,
                        &m, &n))
    return nullptr;
  PyArrayObject* rows = reinterpret_cast<PyArrayObject*>(
      PyArray_FROM_OTF(rows_o, NPY_INT32, NPY_ARRAY_IN_ARRAY));
  PyArrayObject* cols = reinterpret_cast<PyArrayObject*>(
      PyArray_FROM_OTF(cols_o, NPY_INT32, NPY_ARRAY_IN_ARRAY));
  PyArrayObject* vals = reinterpret_cast<PyArrayObject*>(
      PyArray_FROM_OTF(vals_o, NPY_FLOAT64, NPY_ARRAY_IN_ARRAY));
  if (!rows || !cols || !vals) {
    Py_XDECREF(rows); Py_XDECREF(cols); Py_XDECREF(vals);
    return nullptr;
  }
  npy_intp nnz = PyArray_SIZE(vals);
  if (PyArray_SIZE(rows) != nnz || PyArray_SIZE(cols) != nnz) {
    Py_DECREF(rows); Py_DECREF(cols); Py_DECREF(vals);
    PyErr_SetString(PyExc_ValueError, "rows/cols/vals length mismatch");
    return nullptr;
  }
  const int32_t* rp = static_cast<const int32_t*>(PyArray_DATA(rows));
  const int32_t* cp = static_cast<const int32_t*>(PyArray_DATA(cols));
  const double* vp = static_cast<const double*>(PyArray_DATA(vals));

  bool ok = true;
  Py_BEGIN_ALLOW_THREADS
  FILE* f = std::fopen(path, "wb");
  if (!f) {
    ok = false;
  } else {
    std::string buf;
    buf.reserve(static_cast<size_t>(nnz) * 32 + 128);
    buf += "%%MatrixMarket matrix coordinate real general\n";
    char line[96];
    std::snprintf(line, sizeof line, "%ld %ld %lld\n", m, n,
                  static_cast<long long>(nnz));
    buf += line;
    for (npy_intp k = 0; k < nnz; ++k) {
      std::snprintf(line, sizeof line, "%d %d %.17g\n", rp[k] + 1,
                    cp[k] + 1, vp[k]);
      buf += line;
      if (buf.size() > (1u << 22)) {
        if (std::fwrite(buf.data(), 1, buf.size(), f) != buf.size()) {
          ok = false; break;
        }
        buf.clear();
      }
    }
    if (ok && !buf.empty())
      ok = std::fwrite(buf.data(), 1, buf.size(), f) == buf.size();
    std::fclose(f);
  }
  Py_END_ALLOW_THREADS
  Py_DECREF(rows); Py_DECREF(cols); Py_DECREF(vals);
  if (!ok) {
    PyErr_SetString(PyExc_ValueError, "write failed");
    return nullptr;
  }
  Py_RETURN_NONE;
}

PyMethodDef methods[] = {
    {"fast_mm_read", fast_mm_read, METH_VARARGS,
     "Read a MatrixMarket coordinate file -> (rows, cols, vals, m, n)."},
    {"fast_mm_write", fast_mm_write, METH_VARARGS,
     "Write COO (0-based rows, cols, vals, m, n) as MatrixMarket."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_randlapack_native",
    "Native IO helpers for randlapack_tpu_torch.", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__randlapack_native(void) {
  import_array();
  return PyModule_Create(&moduledef);
}
