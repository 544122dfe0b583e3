// CPython extension fast path for the host cell index.
//
// The ctypes wrapper costs ~4 us per single-point query (argument
// marshaling + foreign-call overhead) on top of a ~2.5 us C query — the
// reference KD-tree serves 1.47 us/query total from inside Rust
// (ref: crates/spatial/src/kdtree.rs:25-44, BENCHMARKS.md:43-48). This
// module wraps the SAME index implementation (pcindex.cpp is compiled
// into this TU, so build/query semantics and tie order are identical by
// construction) behind direct CPython entry points: ~0.3 us of call
// overhead instead of ~4.
//
// Loaded as module `_pcquery` by pointclouds_tpu_torch/native/__init__.py;
// its ctypes path remains the fallback where Python.h or numpy's headers
// are missing.

#include <Python.h>

#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include "pcindex.cpp"  // the index implementation (extern "C" entry points)

namespace {

void capsule_free(PyObject* caps) {
    void* h = PyCapsule_GetPointer(caps, "pcidx");
    if (h) pcidx_free(h);
}

Index* index_of(PyObject* caps) {
    return (Index*)PyCapsule_GetPointer(caps, "pcidx");
}

// Read a 3-vector query from any float64 ndarray-like of 3 elements.
// Returns false (with a Python error set) when the object doesn't parse.
bool read_q(PyObject* obj, double out[3]) {
    // Fast path: an aligned contiguous f64[3] ndarray (the common case —
    // a row of a query batch) reads directly; FROM_OTF costs ~1.5 us.
    if (PyArray_Check(obj)) {
        PyArrayObject* a = (PyArrayObject*)obj;
        if (PyArray_TYPE(a) == NPY_DOUBLE && PyArray_NDIM(a) == 1 &&
            PyArray_DIM(a, 0) == 3 && PyArray_ISCARRAY_RO(a)) {
            const double* d = (const double*)PyArray_DATA(a);
            out[0] = d[0];
            out[1] = d[1];
            out[2] = d[2];
            return true;
        }
    }
    PyArrayObject* arr = (PyArrayObject*)PyArray_FROM_OTF(
        obj, NPY_DOUBLE, NPY_ARRAY_ALIGNED);
    if (!arr) return false;
    if (PyArray_SIZE(arr) != 3) {
        Py_DECREF(arr);
        PyErr_SetString(PyExc_ValueError, "query must have 3 elements");
        return false;
    }
    if (PyArray_IS_C_CONTIGUOUS(arr)) {
        const double* d = (const double*)PyArray_DATA(arr);
        out[0] = d[0];
        out[1] = d[1];
        out[2] = d[2];
    } else {
        for (npy_intp i = 0; i < 3; ++i)
            out[i] = *(const double*)PyArray_GETPTR1(arr, i);
    }
    Py_DECREF(arr);
    return true;
}

PyObject* py_build(PyObject*, PyObject* args) {
    PyObject *xyz_o, *valid_o;
    if (!PyArg_ParseTuple(args, "OO", &xyz_o, &valid_o)) return nullptr;
    PyArrayObject* xyz = (PyArrayObject*)PyArray_FROM_OTF(
        xyz_o, NPY_FLOAT32, NPY_ARRAY_IN_ARRAY);
    if (!xyz) return nullptr;
    PyArrayObject* valid = (PyArrayObject*)PyArray_FROM_OTF(
        valid_o, NPY_UINT8, NPY_ARRAY_IN_ARRAY);
    if (!valid) {
        Py_DECREF(xyz);
        return nullptr;
    }
    if (PyArray_NDIM(xyz) != 2 || PyArray_DIM(xyz, 1) != 3 ||
        PyArray_NDIM(valid) != 1 ||
        PyArray_DIM(valid, 0) != PyArray_DIM(xyz, 0)) {
        Py_DECREF(xyz);
        Py_DECREF(valid);
        PyErr_SetString(PyExc_ValueError, "expected xyz [n,3] f32, valid [n]");
        return nullptr;
    }
    const int64_t n = (int64_t)PyArray_DIM(xyz, 0);
    void* h;
    Py_BEGIN_ALLOW_THREADS
    h = pcidx_build((const float*)PyArray_DATA(xyz),
                    (const uint8_t*)PyArray_DATA(valid), n);
    Py_END_ALLOW_THREADS
    Py_DECREF(xyz);
    Py_DECREF(valid);
    return PyCapsule_New(h, "pcidx", capsule_free);
}

PyObject* py_nvalid(PyObject*, PyObject* args) {
    PyObject* caps;
    if (!PyArg_ParseTuple(args, "O", &caps)) return nullptr;
    Index* ix = index_of(caps);
    if (!ix) return nullptr;
    return PyLong_FromLongLong((long long)ix->n_valid);
}

PyObject* py_knn(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
    if (nargs != 3) {
        PyErr_SetString(PyExc_TypeError, "knn(caps, q, k)");
        return nullptr;
    }
    Index* ix = index_of(args[0]);
    if (!ix) return nullptr;
    double q[3];
    if (!read_q(args[1], q)) return nullptr;
    const long long k = PyLong_AsLongLong(args[2]);
    if (k < 0 && PyErr_Occurred()) return nullptr;
    // Stack scratch for the common small-k case; heap above it.
    int64_t rows_s[64];
    double dists_s[64];
    std::vector<int64_t> rows_h;
    std::vector<double> dists_h;
    int64_t* rows = rows_s;
    double* dists = dists_s;
    if (k > 64) {
        rows_h.resize((size_t)k);
        dists_h.resize((size_t)k);
        rows = rows_h.data();
        dists = dists_h.data();
    }
    const int64_t cnt =
        k <= 0 ? 0 : pcidx_knn((void*)ix, q, (int64_t)k, rows, dists);
    npy_intp dim = (npy_intp)cnt;
    PyObject* r = PyArray_SimpleNew(1, &dim, NPY_INT64);
    PyObject* d = PyArray_SimpleNew(1, &dim, NPY_DOUBLE);
    if (!r || !d) {
        Py_XDECREF(r);
        Py_XDECREF(d);
        return nullptr;
    }
    memcpy(PyArray_DATA((PyArrayObject*)r), rows, cnt * sizeof(int64_t));
    memcpy(PyArray_DATA((PyArrayObject*)d), dists, cnt * sizeof(double));
    PyObject* t = PyTuple_New(2);  // steals the refs below
    if (!t) {
        Py_DECREF(r);
        Py_DECREF(d);
        return nullptr;
    }
    PyTuple_SET_ITEM(t, 0, r);
    PyTuple_SET_ITEM(t, 1, d);
    return t;
}

PyObject* py_radius(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
    if (nargs != 3) {
        PyErr_SetString(PyExc_TypeError, "radius(caps, q, r)");
        return nullptr;
    }
    Index* ix = index_of(args[0]);
    if (!ix) return nullptr;
    double q[3];
    if (!read_q(args[1], q)) return nullptr;
    const double r = PyFloat_AsDouble(args[2]);
    if (r == -1.0 && PyErr_Occurred()) return nullptr;
    thread_local std::vector<int64_t> buf;
    if (buf.size() < 256) buf.resize(256);
    int64_t cnt = pcidx_radius((void*)ix, q, r, buf.data(),
                               (int64_t)buf.size());
    if (cnt > (int64_t)buf.size()) {
        buf.resize((size_t)cnt);
        cnt = pcidx_radius((void*)ix, q, r, buf.data(), (int64_t)buf.size());
    }
    if (cnt == 0) {
        // Shared zero-length result (created under the GIL once): a fresh
        // PyArray_SimpleNew costs ~0.1 us — a large slice of a zero-hit
        // query, the reference benchmark's common case.
        static PyObject* empty = nullptr;
        if (!empty) {
            npy_intp zero = 0;
            empty = PyArray_SimpleNew(1, &zero, NPY_INT64);
            if (!empty) return nullptr;
        }
        Py_INCREF(empty);
        return empty;
    }
    npy_intp dim = (npy_intp)cnt;
    PyObject* out = PyArray_SimpleNew(1, &dim, NPY_INT64);
    if (!out) return nullptr;
    memcpy(PyArray_DATA((PyArrayObject*)out), buf.data(),
           cnt * sizeof(int64_t));
    return out;
}

PyObject* py_knn_batch(PyObject*, PyObject* args) {
    PyObject* caps;
    PyObject* qs_o;
    long long k;
    if (!PyArg_ParseTuple(args, "OOL", &caps, &qs_o, &k)) return nullptr;
    Index* ix = index_of(caps);
    if (!ix) return nullptr;
    PyArrayObject* qs = (PyArrayObject*)PyArray_FROM_OTF(
        qs_o, NPY_DOUBLE, NPY_ARRAY_IN_ARRAY);
    if (!qs) return nullptr;
    if (PyArray_NDIM(qs) != 2 || PyArray_DIM(qs, 1) != 3 || k <= 0) {
        Py_DECREF(qs);
        PyErr_SetString(PyExc_ValueError, "expected qs [nq,3] f64, k > 0");
        return nullptr;
    }
    const npy_intp nq = PyArray_DIM(qs, 0);
    npy_intp rdims[2] = {nq, (npy_intp)k};
    npy_intp cdims[1] = {nq};
    PyObject* rows = PyArray_SimpleNew(2, rdims, NPY_INT64);
    PyObject* dists = PyArray_SimpleNew(2, rdims, NPY_DOUBLE);
    PyObject* counts = PyArray_SimpleNew(1, cdims, NPY_INT64);
    if (!rows || !dists || !counts) {
        Py_XDECREF(rows);
        Py_XDECREF(dists);
        Py_XDECREF(counts);
        Py_DECREF(qs);
        return nullptr;
    }
    Py_BEGIN_ALLOW_THREADS
    pcidx_knn_batch((void*)ix, (const double*)PyArray_DATA(qs), (int64_t)nq,
                    (int64_t)k,
                    (int64_t*)PyArray_DATA((PyArrayObject*)rows),
                    (double*)PyArray_DATA((PyArrayObject*)dists),
                    (int64_t*)PyArray_DATA((PyArrayObject*)counts));
    Py_END_ALLOW_THREADS
    Py_DECREF(qs);
    PyObject* t = PyTuple_Pack(3, rows, dists, counts);
    Py_DECREF(rows);
    Py_DECREF(dists);
    Py_DECREF(counts);
    return t;
}

PyMethodDef methods[] = {
    {"build", py_build, METH_VARARGS, "build(xyz f32[n,3], valid u8[n])"},
    {"nvalid", py_nvalid, METH_VARARGS, "nvalid(caps)"},
    {"knn", (PyCFunction)(void*)py_knn, METH_FASTCALL,
     "knn(caps, q, k) -> (rows i64[c], dists f64[c])"},
    {"radius", (PyCFunction)(void*)py_radius, METH_FASTCALL,
     "radius(caps, q, r) -> rows i64[c] (ascending)"},
    {"knn_batch", py_knn_batch, METH_VARARGS,
     "knn_batch(caps, qs f64[nq,3], k) -> (rows, dists, counts)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_pcquery",
    "CPython fast path for the host cell index", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__pcquery(void) {
    import_array();
    return PyModule_Create(&moduledef);
}
