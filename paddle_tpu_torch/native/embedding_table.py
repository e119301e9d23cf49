"""ctypes wrapper for the native sparse-embedding table (embedding_table.cc;
counterpart of paddle_tpu/native/embedding_table.py, the same code over the
port's own build of the source).

Drop-in for the common EmbeddingTable configs (uniform/zeros init,
sgd/adagrad server optimizer, no admission policy): same
pull/push/push_delta/save/load surface, so EmbeddingServer can host it
via table_kwargs backend='native'.
"""
import ctypes
import os

import numpy as np

from . import load_library

_OPTS = {'sgd': 0, 'adagrad': 1}
_INITS = {'uniform': 0, 'zeros': 1}


def _lib():
    lib = load_library('embedding_table')
    if not getattr(lib, '_emb_typed', False):
        lib.emb_create.restype = ctypes.c_void_p
        lib.emb_create.argtypes = [ctypes.c_int, ctypes.c_int,
                                   ctypes.c_float, ctypes.c_int,
                                   ctypes.c_float, ctypes.c_uint64]
        lib.emb_free.argtypes = [ctypes.c_void_p]
        lib.emb_size.restype = ctypes.c_int64
        lib.emb_size.argtypes = [ctypes.c_void_p]
        p_i64 = np.ctypeslib.ndpointer(np.int64, flags='C_CONTIGUOUS')
        p_f32 = np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS')
        lib.emb_pull.argtypes = [ctypes.c_void_p, p_i64, ctypes.c_int64,
                                 p_f32, ctypes.c_int]
        lib.emb_push.argtypes = [ctypes.c_void_p, p_i64, ctypes.c_int64,
                                 p_f32, ctypes.c_float]
        lib.emb_push_delta.argtypes = [ctypes.c_void_p, p_i64,
                                       ctypes.c_int64, p_f32]
        lib.emb_export.restype = ctypes.c_int64
        lib.emb_export.argtypes = [ctypes.c_void_p, p_i64, p_f32, p_f32,
                                   ctypes.c_int64]
        lib.emb_clear.argtypes = [ctypes.c_void_p]
        lib.emb_import.argtypes = [ctypes.c_void_p, p_i64, ctypes.c_int64,
                                   p_f32, p_f32]
        lib._emb_typed = True
    return lib


class NativeEmbeddingTable:
    """One shard, rows + optimizer slots in a C++ arena (reference
    common_sparse_table.cc shard). Thread-safe (C++ mutex); row init is
    deterministic per id (splitmix64), so rebuilt shards agree."""

    def __init__(self, dim, initializer='uniform', init_scale=0.01,
                 optimizer='sgd', lr=0.01, seed=0, entry=None,
                 epsilon=1e-8, eps=None):
        if entry is not None:
            raise ValueError('NativeEmbeddingTable does not run admission '
                             'policies; use the python EmbeddingTable for '
                             'entry-gated tables')
        if optimizer not in _OPTS:
            raise ValueError('native table supports %s, got %r'
                             % (sorted(_OPTS), optimizer))
        if initializer not in _INITS:
            raise ValueError('initializer must be uniform or zeros')
        self.dim = int(dim)
        # epsilon matches the python _SparseOptimizer default (1e-8) so a
        # backend swap does not change adagrad updates; eps= kept as alias
        self._eps = float(eps if eps is not None else epsilon)
        self._optimizer = optimizer
        self._lib = _lib()
        self._ptr = self._lib.emb_create(
            self.dim, _OPTS[optimizer], ctypes.c_float(lr),
            _INITS[initializer], ctypes.c_float(init_scale),
            ctypes.c_uint64(seed))

    def __del__(self):
        ptr = getattr(self, '_ptr', None)
        if ptr:
            self._lib.emb_free(ptr)
            self._ptr = None

    def __len__(self):
        return int(self._lib.emb_size(self._ptr))

    def _ids(self, ids):
        return np.ascontiguousarray(np.asarray(ids, np.int64).reshape(-1))

    def pull(self, ids, create=True):
        ids = self._ids(ids)
        out = np.empty((len(ids), self.dim), np.float32)
        self._lib.emb_pull(self._ptr, ids, len(ids), out, int(create))
        return out

    def push(self, ids, grads):
        ids = self._ids(ids)
        grads = np.ascontiguousarray(np.asarray(grads, np.float32)
                                     .reshape(len(ids), self.dim))
        self._lib.emb_push(self._ptr, ids, len(ids), grads,
                           ctypes.c_float(self._eps))

    def push_delta(self, ids, deltas):
        ids = self._ids(ids)
        deltas = np.ascontiguousarray(np.asarray(deltas, np.float32)
                                      .reshape(len(ids), self.dim))
        self._lib.emb_push_delta(self._ptr, ids, len(ids), deltas)

    def export(self):
        # the table can grow between sizing and exporting (threaded
        # server); emb_export clamps to our capacity and reports the
        # true size under its own lock, so grow-and-retry is race-free
        cap = max(len(self), 1)
        while True:
            keys = np.zeros(cap, np.int64)
            rows = np.zeros((cap, self.dim), np.float32)
            slots = np.zeros((cap, self.dim), np.float32)
            total = int(self._lib.emb_export(self._ptr, keys, rows, slots,
                                             cap))
            if total <= cap:
                return keys[:total], rows[:total], slots[:total]
            cap = total + 1024

    def save(self, path):
        os.makedirs(path, exist_ok=True)
        keys, rows, slots = self.export()
        np.savez(os.path.join(path, 'shard.npz'), keys=keys, vals=rows,
                 slots=slots, optimizer=self._optimizer)

    def load(self, path):
        """Replace the table contents with the checkpoint (python
        EmbeddingTable.load semantics: prior rows are discarded)."""
        data = np.load(os.path.join(path, 'shard.npz'))
        saved_opt = str(data['optimizer']) if 'optimizer' in data else None
        if saved_opt is not None and saved_opt != self._optimizer:
            raise ValueError('checkpoint was written by a %r table; this '
                             'table runs %r' % (saved_opt, self._optimizer))
        keys = np.ascontiguousarray(data['keys'].astype(np.int64))
        rows = np.ascontiguousarray(data['vals'].astype(np.float32))
        slots = np.ascontiguousarray(
            data['slots'].astype(np.float32)) if 'slots' in data else \
            np.zeros_like(rows)
        self._lib.emb_clear(self._ptr)
        if len(keys):
            self._lib.emb_import(self._ptr, keys, len(keys), rows, slots)
