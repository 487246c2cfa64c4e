/* _mcode: native canonical codec for the mochi-tpu wire format.
 *
 * C re-implementation of mochi_tpu_torch/protocol/codec.py (the "mcode"
 * canonical structural encoding: 1-byte tag, varint lengths,
 * bytewise-sorted map keys), so the Python replicas do not spend their
 * time in serialization.
 *
 * Semantics are bit-for-bit identical to codec.py: same tags, same guards
 * (depth 32, 64 MiB lengths, 64-bit varints), same error taxonomy
 * (TypeError on unencodable input, ValueError on malformed bytes).
 * tests/test_torch_native.py runs it differentially against the Python
 * path.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <string.h>

#define T_NONE 0x00
#define T_FALSE 0x01
#define T_TRUE 0x02
#define T_UINT 0x03
#define T_NINT 0x04
#define T_BYTES 0x05
#define T_STR 0x06
#define T_LIST 0x07
#define T_DICT 0x08

#define MAX_DEPTH 32
#define MAX_LEN (64 * 1024 * 1024)

/* ---------------------------------------------------------------- buffer */

typedef struct {
    unsigned char *data;
    Py_ssize_t len;
    Py_ssize_t cap;
} Buf;

static int buf_init(Buf *b) {
    b->cap = 256;
    b->len = 0;
    b->data = PyMem_Malloc(b->cap);
    return b->data ? 0 : -1;
}

static int buf_reserve(Buf *b, Py_ssize_t extra) {
    if (b->len + extra <= b->cap) return 0;
    Py_ssize_t cap = b->cap;
    while (cap < b->len + extra) cap *= 2;
    unsigned char *nd = PyMem_Realloc(b->data, cap);
    if (!nd) return -1;
    b->data = nd;
    b->cap = cap;
    return 0;
}

static int buf_put1(Buf *b, unsigned char c) {
    if (buf_reserve(b, 1) < 0) return -1;
    b->data[b->len++] = c;
    return 0;
}

static int buf_put(Buf *b, const void *src, Py_ssize_t n) {
    if (buf_reserve(b, n) < 0) return -1;
    memcpy(b->data + b->len, src, n);
    b->len += n;
    return 0;
}

static int buf_varint(Buf *b, unsigned long long n) {
    do {
        unsigned char byte = n & 0x7F;
        n >>= 7;
        if (n) byte |= 0x80;
        if (buf_put1(b, byte) < 0) return -1;
    } while (n);
    return 0;
}

/* ---------------------------------------------------------------- encode */

static int encode_value(Buf *b, PyObject *v, int depth);

typedef struct {
    const char *utf8;
    Py_ssize_t len;
    PyObject *key; /* borrowed from keys list */
} KeyEnt;

static int keyent_cmp(const void *pa, const void *pb) {
    const KeyEnt *a = pa, *kb = pb;
    Py_ssize_t n = a->len < kb->len ? a->len : kb->len;
    int c = memcmp(a->utf8, kb->utf8, (size_t)n);
    if (c) return c;
    return a->len < kb->len ? -1 : (a->len > kb->len ? 1 : 0);
}

static int encode_dict(Buf *b, PyObject *v, int depth) {
    Py_ssize_t n = PyDict_Size(v);
    if (buf_put1(b, T_DICT) < 0 || buf_varint(b, (unsigned long long)n) < 0)
        return -1;
    KeyEnt *ents = PyMem_Malloc(sizeof(KeyEnt) * (n ? n : 1));
    if (!ents) {
        PyErr_NoMemory();
        return -1;
    }
    Py_ssize_t pos = 0, i = 0;
    PyObject *key, *val;
    while (PyDict_Next(v, &pos, &key, &val)) {
        if (!PyUnicode_Check(key)) {
            PyErr_Format(PyExc_TypeError, "mcode dict keys must be str, got %.100s",
                         Py_TYPE(key)->tp_name);
            PyMem_Free(ents);
            return -1;
        }
        ents[i].utf8 = PyUnicode_AsUTF8AndSize(key, &ents[i].len);
        if (!ents[i].utf8) {
            PyMem_Free(ents);
            return -1;
        }
        ents[i].key = key;
        i++;
    }
    qsort(ents, (size_t)n, sizeof(KeyEnt), keyent_cmp);
    for (i = 0; i < n; i++) {
        if (buf_put1(b, T_STR) < 0 ||
            buf_varint(b, (unsigned long long)ents[i].len) < 0 ||
            buf_put(b, ents[i].utf8, ents[i].len) < 0) {
            PyMem_Free(ents);
            return -1;
        }
        /* dict may be mutated by __eq__ during PyDict_GetItem in pathological
         * cases; use the captured key object directly */
        PyObject *item = PyDict_GetItemWithError(v, ents[i].key);
        if (!item) {
            if (!PyErr_Occurred())
                PyErr_SetString(PyExc_RuntimeError, "mcode: dict changed during encode");
            PyMem_Free(ents);
            return -1;
        }
        if (encode_value(b, item, depth + 1) < 0) {
            PyMem_Free(ents);
            return -1;
        }
    }
    PyMem_Free(ents);
    return 0;
}

static int encode_value(Buf *b, PyObject *v, int depth) {
    if (depth > MAX_DEPTH) {
        PyErr_SetString(PyExc_ValueError, "mcode: structure too deep");
        return -1;
    }
    if (v == Py_None) return buf_put1(b, T_NONE);
    if (v == Py_True) return buf_put1(b, T_TRUE);
    if (v == Py_False) return buf_put1(b, T_FALSE);
    if (PyLong_Check(v)) {
        /* sign via comparison: Py_SIZE() is invalid for PyLong in 3.12 */
        PyObject *zero = PyLong_FromLong(0);
        if (!zero) return -1;
        int neg = PyObject_RichCompareBool(v, zero, Py_LT);
        Py_DECREF(zero);
        if (neg < 0) return -1;
        unsigned long long u;
        if (!neg) {
            u = PyLong_AsUnsignedLongLong(v);
            if (u == (unsigned long long)-1 && PyErr_Occurred()) {
                PyErr_Clear();
                PyErr_Format(PyExc_TypeError, "mcode int out of range");
                return -1;
            }
            if (buf_put1(b, T_UINT) < 0) return -1;
        } else {
            PyObject *inv = PyNumber_Invert(v); /* ~n == -1 - n >= 0 */
            if (!inv) return -1;
            u = PyLong_AsUnsignedLongLong(inv);
            Py_DECREF(inv);
            if (u == (unsigned long long)-1 && PyErr_Occurred()) {
                PyErr_Clear();
                PyErr_Format(PyExc_TypeError, "mcode int out of range");
                return -1;
            }
            if (buf_put1(b, T_NINT) < 0) return -1;
        }
        return buf_varint(b, u);
    }
    if (PyBytes_Check(v) || PyByteArray_Check(v) || PyMemoryView_Check(v)) {
        Py_buffer view;
        if (PyObject_GetBuffer(v, &view, PyBUF_SIMPLE) < 0) return -1;
        int rc = (buf_put1(b, T_BYTES) < 0 ||
                  buf_varint(b, (unsigned long long)view.len) < 0 ||
                  buf_put(b, view.buf, view.len) < 0)
                     ? -1
                     : 0;
        PyBuffer_Release(&view);
        return rc;
    }
    if (PyUnicode_Check(v)) {
        Py_ssize_t len;
        const char *utf8 = PyUnicode_AsUTF8AndSize(v, &len);
        if (!utf8) return -1;
        if (buf_put1(b, T_STR) < 0 ||
            buf_varint(b, (unsigned long long)len) < 0 ||
            buf_put(b, utf8, len) < 0)
            return -1;
        return 0;
    }
    if (PyList_Check(v) || PyTuple_Check(v)) {
        PyObject *fast = PySequence_Fast(v, "mcode: sequence");
        if (!fast) return -1;
        Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
        if (buf_put1(b, T_LIST) < 0 || buf_varint(b, (unsigned long long)n) < 0) {
            Py_DECREF(fast);
            return -1;
        }
        for (Py_ssize_t i = 0; i < n; i++) {
            if (encode_value(b, PySequence_Fast_GET_ITEM(fast, i), depth + 1) < 0) {
                Py_DECREF(fast);
                return -1;
            }
        }
        Py_DECREF(fast);
        return 0;
    }
    if (PyDict_Check(v)) return encode_dict(b, v, depth);
    PyErr_Format(PyExc_TypeError, "mcode cannot encode %.100s", Py_TYPE(v)->tp_name);
    return -1;
}

static PyObject *mcode_encode(PyObject *self, PyObject *arg) {
    Buf b;
    if (buf_init(&b) < 0) return PyErr_NoMemory();
    if (encode_value(&b, arg, 0) < 0) {
        PyMem_Free(b.data);
        return NULL;
    }
    PyObject *out = PyBytes_FromStringAndSize((const char *)b.data, b.len);
    PyMem_Free(b.data);
    return out;
}

/* ---------------------------------------------------------------- decode */

typedef struct {
    const unsigned char *data;
    Py_ssize_t len;
    Py_ssize_t pos;
} Rd;

static int rd_varint(Rd *r, unsigned long long *out) {
    int shift = 0;
    unsigned long long result = 0;
    for (;;) {
        if (r->pos >= r->len) {
            PyErr_SetString(PyExc_ValueError, "mcode: truncated varint");
            return -1;
        }
        unsigned char byte = r->data[r->pos++];
        result |= (unsigned long long)(byte & 0x7F) << shift;
        if (!(byte & 0x80)) {
            /* match python: reject >= 2**64; shift<=63 plus final byte can
             * overflow only if shift==63 and byte>1 */
            if (shift == 63 && (byte & 0x7F) > 1) {
                PyErr_SetString(PyExc_ValueError, "mcode: varint out of 64-bit range");
                return -1;
            }
            /* canonical-only: a multi-byte varint ending in 0x00 carries no
             * bits in its last byte => non-minimal encoding.  The encoder
             * only emits minimal forms; accepting others would let two
             * distinct frames decode identically (signed-slice attacks). */
            if (shift > 0 && byte == 0) {
                PyErr_SetString(PyExc_ValueError, "mcode: non-canonical varint");
                return -1;
            }
            *out = result;
            return 0;
        }
        shift += 7;
        if (shift > 63) {
            PyErr_SetString(PyExc_ValueError, "mcode: varint too long");
            return -1;
        }
    }
}

static PyObject *rd_value(Rd *r, int depth) {
    if (depth > MAX_DEPTH) {
        PyErr_SetString(PyExc_ValueError, "mcode: structure too deep");
        return NULL;
    }
    if (r->pos >= r->len) {
        PyErr_SetString(PyExc_ValueError, "mcode: truncated input");
        return NULL;
    }
    unsigned char tag = r->data[r->pos++];
    unsigned long long n;
    switch (tag) {
    case T_NONE:
        Py_RETURN_NONE;
    case T_TRUE:
        Py_RETURN_TRUE;
    case T_FALSE:
        Py_RETURN_FALSE;
    case T_UINT:
        if (rd_varint(r, &n) < 0) return NULL;
        return PyLong_FromUnsignedLongLong(n);
    case T_NINT: {
        if (rd_varint(r, &n) < 0) return NULL;
        PyObject *pos_val = PyLong_FromUnsignedLongLong(n);
        if (!pos_val) return NULL;
        PyObject *out = PyNumber_Invert(pos_val); /* -1 - n */
        Py_DECREF(pos_val);
        return out;
    }
    case T_BYTES:
    case T_STR: {
        if (rd_varint(r, &n) < 0) return NULL;
        if (n > MAX_LEN) {
            PyErr_SetString(PyExc_ValueError, "mcode: length guard exceeded");
            return NULL;
        }
        if (r->pos + (Py_ssize_t)n > r->len) {
            PyErr_SetString(PyExc_ValueError, "mcode: truncated value");
            return NULL;
        }
        const char *p = (const char *)r->data + r->pos;
        r->pos += (Py_ssize_t)n;
        if (tag == T_BYTES) return PyBytes_FromStringAndSize(p, (Py_ssize_t)n);
        return PyUnicode_DecodeUTF8(p, (Py_ssize_t)n, NULL);
    }
    case T_LIST: {
        if (rd_varint(r, &n) < 0) return NULL;
        if (n > MAX_LEN) {
            PyErr_SetString(PyExc_ValueError, "mcode: list guard exceeded");
            return NULL;
        }
        /* Every element costs >= 1 byte (its tag), so a count larger than
         * the remaining input is guaranteed truncated.  Fail fast instead of
         * preallocating attacker-controlled (pre-authentication) memory. */
        if ((Py_ssize_t)n > r->len - r->pos) {
            PyErr_SetString(PyExc_ValueError, "mcode: truncated list");
            return NULL;
        }
        PyObject *list = PyList_New((Py_ssize_t)n);
        if (!list) return NULL;
        for (Py_ssize_t i = 0; i < (Py_ssize_t)n; i++) {
            PyObject *item = rd_value(r, depth + 1);
            if (!item) {
                Py_DECREF(list);
                return NULL;
            }
            PyList_SET_ITEM(list, i, item);
        }
        return list;
    }
    case T_DICT: {
        if (rd_varint(r, &n) < 0) return NULL;
        if (n > MAX_LEN) {
            PyErr_SetString(PyExc_ValueError, "mcode: dict guard exceeded");
            return NULL;
        }
        PyObject *dict = PyDict_New();
        if (!dict) return NULL;
        for (unsigned long long i = 0; i < n; i++) {
            PyObject *key = rd_value(r, depth + 1);
            if (!key) {
                Py_DECREF(dict);
                return NULL;
            }
            if (!PyUnicode_Check(key)) {
                Py_DECREF(key);
                Py_DECREF(dict);
                PyErr_SetString(PyExc_ValueError, "mcode: dict key must be str");
                return NULL;
            }
            PyObject *val = rd_value(r, depth + 1);
            if (!val) {
                Py_DECREF(key);
                Py_DECREF(dict);
                return NULL;
            }
            if (PyDict_SetItem(dict, key, val) < 0) {
                Py_DECREF(key);
                Py_DECREF(val);
                Py_DECREF(dict);
                return NULL;
            }
            Py_DECREF(key);
            Py_DECREF(val);
        }
        return dict;
    }
    default:
        PyErr_Format(PyExc_ValueError, "mcode: unknown tag 0x%x", (int)tag);
        return NULL;
    }
}

static PyObject *mcode_decode(PyObject *self, PyObject *arg) {
    Py_buffer view;
    if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0) return NULL;
    Rd r = {(const unsigned char *)view.buf, view.len, 0};
    PyObject *out = rd_value(&r, 0);
    if (out && r.pos != r.len) {
        Py_DECREF(out);
        out = NULL;
        PyErr_SetString(PyExc_ValueError, "mcode: trailing bytes after value");
    }
    PyBuffer_Release(&view);
    return out;
}

/* Envelope fast path: decode a wire envelope (top-level 8-element list) and
 * additionally report the stream offset just past element 6.  The signing
 * bytes are "mochi.env\0" + T_LIST + varint(6) + wire[2:off6] — the signed
 * prefix is a contiguous slice of the wire encoding — so the receiver can
 * authenticate without re-encoding the payload tree (the dominant cost of
 * the Python signing_bytes() path, see protocol/messages.py).  Returns
 * (list_of_8_values, off6). */
static PyObject *mcode_decode_env(PyObject *self, PyObject *arg) {
    Py_buffer view;
    if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0) return NULL;
    Rd r = {(const unsigned char *)view.buf, view.len, 0};
    PyObject *list = NULL;
    Py_ssize_t off6 = 0;
    if (r.len < 2 || r.data[0] != T_LIST) {
        PyErr_SetString(PyExc_ValueError, "mcode: envelope must be a list");
        goto fail;
    }
    r.pos = 1;
    unsigned long long n;
    if (rd_varint(&r, &n) < 0) goto fail;
    if (n != 8) {
        PyErr_Format(PyExc_ValueError, "mcode: envelope needs 8 elements, got %llu", n);
        goto fail;
    }
    list = PyList_New(8);
    if (!list) goto fail;
    for (Py_ssize_t i = 0; i < 8; i++) {
        PyObject *item = rd_value(&r, 1);
        if (!item) goto fail;
        PyList_SET_ITEM(list, i, item);
        if (i == 5) off6 = r.pos;
    }
    if (r.pos != r.len) {
        PyErr_SetString(PyExc_ValueError, "mcode: trailing bytes after value");
        goto fail;
    }
    PyBuffer_Release(&view);
    return Py_BuildValue("(Nn)", list, off6);
fail:
    Py_XDECREF(list);
    PyBuffer_Release(&view);
    return NULL;
}

static PyMethodDef mcode_methods[] = {
    {"encode", mcode_encode, METH_O, "Canonically encode a structural value to bytes."},
    {"decode", mcode_decode, METH_O, "Decode mcode bytes; rejects trailing garbage."},
    {"decode_env", mcode_decode_env, METH_O,
     "Decode an 8-element envelope list; returns (values, offset_past_elem6)."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef mcode_module = {
    PyModuleDef_HEAD_INIT, "_mcode", "Native mcode canonical codec.", -1, mcode_methods,
};

PyMODINIT_FUNC PyInit__mcode(void) { return PyModule_Create(&mcode_module); }
