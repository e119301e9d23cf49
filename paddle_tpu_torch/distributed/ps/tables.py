"""Parameter-server table zoo beyond the sparse embedding table
(counterpart of paddle_tpu/distributed/ps/tables.py, the same code).

Parity (SURVEY.md §2.1 "PS tables", reference distributed/table/):
  CommonDenseTable   -> DenseTable   (dense params, server-side optimizer)
  BarrierTable       -> BarrierTable (worker sync point)
  TensorTable        -> TensorTable  (named server-side dense tensors)
  SparseGeoTable     -> GeoSparseTable (geo-SGD delta aggregation)
  SsdSparseTable     -> SsdSparseTable (sqlite-backed overflow tier —
                        rocksdb's role, stdlib-only)
"""
import os
import sqlite3
import threading

import numpy as np

from .embedding_service import EmbeddingTable, _SparseOptimizer

__all__ = ['DenseTable', 'BarrierTable', 'TensorTable', 'GeoSparseTable',
           'SsdSparseTable']


class DenseTable:
    """Dense parameter block with the optimizer applied server-side
    (reference table/common_dense_table.cc + depends/dense.h)."""

    def __init__(self, shape, optimizer='sgd', lr=0.01, init='zeros',
                 seed=0):
        rng = np.random.RandomState(seed)
        if init == 'zeros':
            self._value = np.zeros(shape, np.float32)
        else:
            self._value = rng.uniform(-0.01, 0.01, shape).astype(np.float32)
        self._opt = _SparseOptimizer(optimizer, lr)
        self._slots = [np.zeros(shape, np.float32)
                       for _ in range(self._opt.slot_count())]
        self._lock = threading.Lock()

    def pull(self):
        with self._lock:
            return self._value.copy()

    def push(self, grad):
        grad = np.asarray(grad, np.float32)
        with self._lock:
            new_v, new_slots = self._opt.apply(self._value.copy(),
                                               list(self._slots), grad)
            self._value = new_v
            self._slots = new_slots if new_slots else self._slots

    def set(self, value):
        with self._lock:
            self._value = np.asarray(value, np.float32).copy()

    def save(self, path):
        os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
        with self._lock:
            np.savez(path, value=self._value,
                     slots=np.stack(self._slots) if self._slots else
                     np.zeros((0,) + self._value.shape, np.float32))

    def load(self, path):
        data = np.load(path if path.endswith('.npz') else path + '.npz')
        with self._lock:
            self._value = data['value']
            self._slots = [s for s in data['slots']]

    def state_dict(self):
        with self._lock:
            return {'value': self._value.copy(),
                    'slots': [s.copy() for s in self._slots]}

    def set_state_dict(self, state):
        with self._lock:
            self._value = np.asarray(state['value'], np.float32).copy()
            self._slots = [np.asarray(s, np.float32).copy()
                           for s in state['slots']]


class TensorTable:
    """Named server-side dense tensors (reference table/tensor_table.cc —
    which runs a program server-side; here: plain set/get/increment, the
    part PS users actually depend on: global counters & stats)."""

    def __init__(self):
        self._tensors = {}
        self._lock = threading.Lock()

    def set(self, name, value):
        with self._lock:
            self._tensors[name] = np.asarray(value, np.float32).copy()

    def get(self, name):
        with self._lock:
            v = self._tensors.get(name)
            return None if v is None else v.copy()

    def increment(self, name, delta):
        with self._lock:
            cur = self._tensors.get(name)
            delta = np.asarray(delta, np.float32)
            self._tensors[name] = delta.copy() if cur is None \
                else cur + delta
            return self._tensors[name].copy()

    def state_dict(self):
        with self._lock:
            return {'tensors': {k: v.copy()
                                for k, v in self._tensors.items()}}

    def set_state_dict(self, state):
        with self._lock:
            self._tensors = {str(k): np.asarray(v, np.float32).copy()
                             for k, v in state['tensors'].items()}


class BarrierTable:
    """Counting barrier across `trigger_count` workers (reference
    table/barrier_table.cc). Reusable: each full round bumps a
    generation."""

    def __init__(self, trigger_count):
        self.trigger = int(trigger_count)
        self._count = 0
        self._gen = 0
        self._cv = threading.Condition()

    def barrier(self, worker_id=None, timeout=60.0):
        with self._cv:
            gen = self._gen
            self._count += 1
            if self._count >= self.trigger:
                self._count = 0
                self._gen += 1
                self._cv.notify_all()
                return True
            ok = self._cv.wait_for(lambda: self._gen != gen,
                                   timeout=timeout)
            if not ok:
                # withdraw this arrival — leaving it counted would let a
                # later round release with fewer live workers than trigger
                if self._gen == gen and self._count > 0:
                    self._count -= 1
                raise TimeoutError('barrier timed out (%d/%d arrived)'
                                   % (self._count, self.trigger))
            return True


class GeoSparseTable(EmbeddingTable):
    """Geo-SGD sparse table (reference table/sparse_geo_table.cc):
    workers train local replicas and push parameter DELTAS, which the
    server adds — no server-side optimizer on the delta path."""

    def push_delta(self, ids, deltas):
        with self._lock:
            for key, d in zip(ids, deltas):
                row = self._rows.get(key)
                if row is None:
                    row = self._new_row()
                    nslots = self._opt.slot_count()
                    if nslots:  # mirror pull(): a later grad push on this
                        # key must find initialized optimizer slots
                        self._slots[key] = [np.zeros(self.dim, np.float32)
                                            for _ in range(nslots)]
                self._rows[key] = row + d

    def pull_geo(self, ids):
        return self.pull(ids)


class SsdSparseTable(EmbeddingTable):
    """Sparse table with a bounded in-memory hot set and an sqlite-backed
    cold tier (reference table/ssd_sparse_table.cc over rocksdb). Rows are
    promoted on access and demoted in insertion order when the hot set
    exceeds `max_mem_rows`."""

    def __init__(self, dim, max_mem_rows=100000, db_path=None, **kwargs):
        super().__init__(dim, **kwargs)
        self.max_mem_rows = int(max_mem_rows)
        self._db_path = db_path or ':memory:'
        self._db = sqlite3.connect(self._db_path, check_same_thread=False)
        self._db.execute('CREATE TABLE IF NOT EXISTS rows '
                         '(id INTEGER PRIMARY KEY, val BLOB, slots BLOB)')
        self._db_lock = threading.Lock()

    def _demote_if_needed(self):
        # caller holds self._lock
        while len(self._rows) > self.max_mem_rows:
            key, row = next(iter(self._rows.items()))
            slots = self._slots.pop(key, [])
            del self._rows[key]
            blob = row.astype(np.float32).tobytes()
            sblob = np.concatenate([s.ravel() for s in slots]).astype(
                np.float32).tobytes() if slots else b''
            with self._db_lock:
                self._db.execute(
                    'INSERT OR REPLACE INTO rows VALUES (?,?,?)',
                    (int(key), blob, sblob))

    def _promote(self, key):
        # caller holds self._lock; returns row or None
        with self._db_lock:
            cur = self._db.execute(
                'SELECT val, slots FROM rows WHERE id=?', (int(key),))
            hit = cur.fetchone()
            if hit is None:
                return None
            self._db.execute('DELETE FROM rows WHERE id=?', (int(key),))
        row = np.frombuffer(hit[0], np.float32).copy()
        self._rows[key] = row
        nslots = self._opt.slot_count()
        if nslots:
            if hit[1]:
                flat = np.frombuffer(hit[1], np.float32).copy()
                self._slots[key] = [flat[i * self.dim:(i + 1) * self.dim]
                                    for i in range(nslots)]
            else:
                self._slots[key] = [np.zeros(self.dim, np.float32)
                                    for _ in range(nslots)]
        return row

    def pull(self, ids):
        out = np.empty((len(ids), self.dim), np.float32)
        with self._lock:
            for i, key in enumerate(ids):
                row = self._rows.get(key)
                if row is None:
                    row = self._promote(key)
                if row is None:
                    row = self._new_row()
                    self._rows[key] = row
                    nslots = self._opt.slot_count()
                    if nslots:
                        self._slots[key] = [np.zeros(self.dim, np.float32)
                                            for _ in range(nslots)]
                out[i] = row
            self._demote_if_needed()
        return out

    def push(self, ids, grads):
        with self._lock:
            for key, g in zip(ids, grads):
                if key not in self._rows and self._promote(key) is None:
                    continue
                row = self._rows[key]
                slots = self._slots.get(key, [])
                new_row, new_slots = self._opt.apply(row.copy(),
                                                     list(slots), g)
                self._rows[key] = new_row
                if new_slots:
                    self._slots[key] = new_slots
            self._demote_if_needed()

    def save(self, path):
        """Persist BOTH tiers, values AND optimizer slots (dropping slots
        across a checkpoint would reset adagrad/adam state — and break a
        later push on a loaded row)."""
        os.makedirs(path, exist_ok=True)
        nslots = self._opt.slot_count()
        empty = np.zeros(nslots * self.dim, np.float32)
        with self._lock:
            keys = list(self._rows.keys())
            vals = [v.copy() for v in self._rows.values()]
            slots = []
            for k in keys:
                s = self._slots.get(k)
                slots.append(np.concatenate([x.ravel() for x in s])
                             if s else empty.copy())
            with self._db_lock:
                for kid, blob, sblob in self._db.execute(
                        'SELECT id, val, slots FROM rows'):
                    keys.append(int(kid))
                    vals.append(np.frombuffer(blob, np.float32))
                    slots.append(np.frombuffer(sblob, np.float32)
                                 if sblob else empty.copy())
        np.savez(os.path.join(path, 'shard.npz'),
                 keys=np.asarray(keys, np.int64),
                 vals=np.stack(vals) if vals else
                 np.zeros((0, self.dim), np.float32),
                 slots=np.stack(slots) if slots else
                 np.zeros((0, nslots * self.dim), np.float32))

    def load(self, path):
        data = np.load(os.path.join(path, 'shard.npz'))
        nslots = self._opt.slot_count()
        with self._lock:
            with self._db_lock:
                self._db.execute('DELETE FROM rows')
            self._rows = {int(k): v.copy()
                          for k, v in zip(data['keys'], data['vals'])}
            self._slots = {}
            if nslots:
                saved = data['slots'] if 'slots' in data else None
                for i, k in enumerate(data['keys']):
                    if saved is not None and saved.shape[0] > i and \
                            saved.shape[1] == nslots * self.dim:
                        flat = saved[i].copy()
                    else:  # legacy checkpoint without slots: re-init zeros
                        flat = np.zeros(nslots * self.dim, np.float32)
                    self._slots[int(k)] = [
                        flat[j * self.dim:(j + 1) * self.dim]
                        for j in range(nslots)]
            self._demote_if_needed()

    def mem_rows(self):
        with self._lock:
            return len(self._rows)

    def disk_rows(self):
        with self._db_lock:
            return self._db.execute('SELECT COUNT(*) FROM rows'
                                    ).fetchone()[0]

    def __len__(self):
        return self.mem_rows() + self.disk_rows()
