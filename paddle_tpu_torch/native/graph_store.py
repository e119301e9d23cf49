"""ctypes binding for graph_store.cc + pure-Python fallback (counterpart of
paddle_tpu/native/graph_store.py, the same code over the port's own build
of the source).

API parity target: distributed/table/common_graph_table.h:64-130 (GraphTable
ops: load edges/nodes, random_sample_neighboors, random_sample_nodes,
pull_graph_list, get/set_node_feat).
"""
import ctypes
import os

import numpy as np

from . import load_library

__all__ = ['GraphStore']


class _NativeStore:
    def __init__(self, shard_num=16, seed=None):
        self._lib = load_library('graph_store')
        lib = self._lib
        lib.gs_create.restype = ctypes.c_void_p
        lib.gs_create.argtypes = [ctypes.c_int]
        lib.gs_free.argtypes = [ctypes.c_void_p]
        lib.gs_add_edges.restype = ctypes.c_int64
        lib.gs_add_edges.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int64]
        lib.gs_add_nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int64]
        lib.gs_remove_nodes.restype = ctypes.c_int64
        lib.gs_remove_nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_int64]
        lib.gs_load_edge_file.restype = ctypes.c_int64
        lib.gs_load_edge_file.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                          ctypes.c_int]
        lib.gs_node_count.restype = ctypes.c_int64
        lib.gs_node_count.argtypes = [ctypes.c_void_p]
        lib.gs_edge_count.restype = ctypes.c_int64
        lib.gs_edge_count.argtypes = [ctypes.c_void_p]
        lib.gs_get_degree.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int64, ctypes.c_void_p]
        lib.gs_sample_neighbors.restype = ctypes.c_int64
        lib.gs_sample_neighbors.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.c_int64, ctypes.c_int,
                                            ctypes.c_void_p, ctypes.c_int64]
        lib.gs_random_sample_nodes.restype = ctypes.c_int64
        lib.gs_random_sample_nodes.argtypes = [ctypes.c_void_p,
                                               ctypes.c_int64,
                                               ctypes.c_void_p]
        lib.gs_pull_graph_list.restype = ctypes.c_int64
        lib.gs_pull_graph_list.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_int64, ctypes.c_int64,
                                           ctypes.c_void_p]
        lib.gs_set_node_feat.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_void_p, ctypes.c_int]
        lib.gs_get_node_feat.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_int64, ctypes.c_int,
                                         ctypes.c_void_p]
        lib.gs_seed.argtypes = [ctypes.c_uint64]
        self._h = lib.gs_create(shard_num)
        self.shard_num = shard_num
        if seed is not None:
            lib.gs_seed(seed)

    def __del__(self):
        if getattr(self, '_h', None):
            self._lib.gs_free(self._h)
            self._h = None

    @staticmethod
    def _i64(a):
        return np.ascontiguousarray(np.asarray(a, dtype=np.int64))

    def add_edges(self, src, dst, weight=None):
        src = self._i64(src)
        dst = self._i64(dst)
        w = np.ascontiguousarray(np.asarray(weight, np.float32)) \
            if weight is not None else None
        return self._lib.gs_add_edges(
            self._h, src.ctypes.data, dst.ctypes.data,
            w.ctypes.data if w is not None else None, len(src))

    def add_nodes(self, ids):
        ids = self._i64(ids)
        return self._lib.gs_add_nodes(self._h, ids.ctypes.data, len(ids))

    def remove_nodes(self, ids):
        ids = self._i64(ids)
        return self._lib.gs_remove_nodes(self._h, ids.ctypes.data,
                                         len(ids))

    def load_edge_file(self, path, reversed=False):
        return self._lib.gs_load_edge_file(self._h, path.encode(),
                                           1 if reversed else 0)

    def node_count(self):
        return self._lib.gs_node_count(self._h)

    def edge_count(self):
        return self._lib.gs_edge_count(self._h)

    def degree(self, ids):
        ids = self._i64(ids)
        out = np.empty(len(ids), np.int64)
        self._lib.gs_get_degree(self._h, ids.ctypes.data, len(ids),
                                out.ctypes.data)
        return out

    def sample_neighbors(self, ids, sample_size, pad=-1):
        ids = self._i64(ids)
        out = np.empty((len(ids), sample_size), np.int64)
        self._lib.gs_sample_neighbors(self._h, ids.ctypes.data, len(ids),
                                      sample_size, out.ctypes.data, pad)
        return out

    def random_sample_nodes(self, k):
        out = np.empty(k, np.int64)
        n = self._lib.gs_random_sample_nodes(self._h, k, out.ctypes.data)
        return out[:n]

    def pull_graph_list(self, shard, cursor, cap):
        out = np.empty(cap, np.int64)
        n = self._lib.gs_pull_graph_list(self._h, shard, cursor, cap,
                                         out.ctypes.data)
        return out[:n]

    def set_node_feat(self, node_id, feat):
        feat = np.ascontiguousarray(np.asarray(feat, np.float32))
        self._lib.gs_set_node_feat(self._h, int(node_id), feat.ctypes.data,
                                   len(feat))

    def get_node_feat(self, ids, dim):
        ids = self._i64(ids)
        out = np.zeros((len(ids), dim), np.float32)
        self._lib.gs_get_node_feat(self._h, ids.ctypes.data, len(ids), dim,
                                   out.ctypes.data)
        return out


class _PythonStore:
    """Fallback with identical semantics (uniform/weighted sampling)."""

    def __init__(self, shard_num=16, seed=None):
        self.shard_num = shard_num
        self._nbrs = {}
        self._weights = {}
        self._feat = {}
        self._rng = np.random.RandomState(seed)

    def _push(self, s, d, w):
        # mirror native push_edge: a missing weight means 1.0, and a late
        # first weight backfills 1.0, so weights is always absent or
        # len(nbrs) long
        nbrs = self._nbrs.setdefault(s, [])
        nbrs.append(d)
        ws = self._weights.get(s)
        if w is not None:
            if ws is None:
                ws = self._weights.setdefault(s, [])
            if len(ws) + 1 < len(nbrs):
                ws.extend([1.0] * (len(nbrs) - 1 - len(ws)))
            ws.append(float(w))
        elif ws is not None:
            ws.append(1.0)

    def add_edges(self, src, dst, weight=None):
        for i, (s, d) in enumerate(zip(np.asarray(src), np.asarray(dst))):
            self._push(int(s), int(d),
                       float(weight[i]) if weight is not None else None)
        return len(src)

    def add_nodes(self, ids):
        for i in ids:
            self._nbrs.setdefault(int(i), [])
        return len(ids)

    def remove_nodes(self, ids):
        removed = 0
        for i in ids:
            k = int(i)
            # a node may exist with only a feature (set_node_feat creates
            # it in the native store) — treat either presence as a node
            if k in self._nbrs or k in self._feat:
                self._nbrs.pop(k, None)
                self._weights.pop(k, None)
                self._feat.pop(k, None)
                removed += 1
        return removed

    def load_edge_file(self, path, reversed=False):
        n = 0
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 2:
                    continue
                a, b = int(parts[0]), int(parts[1])
                if reversed:
                    a, b = b, a
                self._push(a, b, float(parts[2]) if len(parts) >= 3 else None)
                n += 1
        return n

    def node_count(self):
        return len(self._nbrs)

    def edge_count(self):
        return sum(len(v) for v in self._nbrs.values())

    def degree(self, ids):
        return np.asarray([len(self._nbrs.get(int(i), [])) for i in ids],
                          np.int64)

    def sample_neighbors(self, ids, sample_size, pad=-1):
        out = np.full((len(ids), sample_size), pad, np.int64)
        for r, i in enumerate(np.asarray(ids)):
            nbrs = self._nbrs.get(int(i), [])
            if not nbrs:
                continue
            w = self._weights.get(int(i))
            if w:
                p = np.asarray(w) / np.sum(w)
                out[r] = self._rng.choice(nbrs, sample_size, p=p)
            else:
                out[r] = self._rng.choice(nbrs, sample_size)
        return out

    def random_sample_nodes(self, k):
        keys = np.asarray(list(self._nbrs.keys()), np.int64)
        if len(keys) <= k:
            return keys
        return self._rng.choice(keys, k, replace=False)

    def pull_graph_list(self, shard, cursor, cap):
        keys = [i for i in self._nbrs if i % self.shard_num == shard]
        return np.asarray(keys[cursor:cursor + cap], np.int64)

    def set_node_feat(self, node_id, feat):
        self._feat[int(node_id)] = np.asarray(feat, np.float32)

    def get_node_feat(self, ids, dim):
        out = np.zeros((len(ids), dim), np.float32)
        for r, i in enumerate(np.asarray(ids)):
            f = self._feat.get(int(i))
            if f is not None and len(f) == dim:
                out[r] = f
        return out


def GraphStore(shard_num=16, seed=None, force_python=False):
    if not force_python:
        try:
            return _NativeStore(shard_num, seed)
        except Exception:
            pass
    return _PythonStore(shard_num, seed)
