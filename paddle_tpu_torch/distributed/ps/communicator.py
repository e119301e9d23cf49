"""Worker-side communicator: batches gradient sends to the PS on
background threads (counterpart of
paddle_tpu/distributed/ps/communicator.py, the same code). Its send
thread handles numpy arrays only: callers hand it host copies, never a
CUDA tensor.

Parity: distributed/service/communicator.h — AsyncCommunicator (:348,
queue + merge + background send), HalfAsyncCommunicator (:423, async sends
with a drain barrier), SyncCommunicator (:468, send inline each step),
GeoCommunicator (:497, push parameter DELTAS every k local updates).
"""
import queue
import threading

import numpy as np

__all__ = ['Communicator', 'AsyncCommunicator', 'HalfAsyncCommunicator',
           'SyncCommunicator', 'GeoCommunicator']


def _merge_by_id(ids, grads):
    """Sum duplicate-id gradients (communicator merge_sparse_grad)."""
    ids = np.asarray(ids, np.int64)
    grads = np.asarray(grads, np.float32)
    uniq, inv = np.unique(ids, return_inverse=True)
    merged = np.zeros((len(uniq), grads.shape[1]), np.float32)
    np.add.at(merged, inv, grads)
    return uniq, merged


class Communicator:
    """mode: 'async' | 'half_async' | 'sync' | 'geo'."""

    def __init__(self, client, mode='async', send_queue_size=20,
                 merge_size=2, geo_need_push_nums=100):
        assert mode in ('async', 'half_async', 'sync', 'geo')
        self.client = client
        self.mode = mode
        self.merge_size = max(int(merge_size), 1)
        self.geo_need_push_nums = int(geo_need_push_nums)
        self._queue = queue.Queue(maxsize=send_queue_size)
        self._thread = None
        self._running = False
        self._pending = 0
        self._pending_cv = threading.Condition()
        self._send_error = None  # first error from the send loop
        # geo state: local deltas accumulated per table
        self._geo_acc = {}
        self._geo_count = 0
        self._geo_lock = threading.Lock()

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        # sync sends inline; geo accumulates and flushes from the pushing
        # thread — neither has work for a background send loop
        if self.mode in ('sync', 'geo') or self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._send_loop, daemon=True)
        self._thread.start()

    def stop(self):
        try:
            self.flush()
        finally:
            # shut the thread down even when flush surfaces a deferred
            # send error — stop() must leave no live background thread
            self._running = False
            if self._thread is not None:
                self._queue.put(None)   # wake the loop
                self._thread.join(timeout=5)
                self._thread = None

    is_running = property(lambda self: self._running)

    # -- send path -----------------------------------------------------------
    def push_sparse_grad(self, table_id, ids, grads):
        if self.mode == 'sync':
            uniq, merged = _merge_by_id(ids, grads)
            self.client.push(table_id, uniq, merged)
            return
        if self.mode == 'geo':
            raise RuntimeError('geo mode pushes deltas: use '
                               'push_sparse_param(table_id, ids, deltas)')
        with self._pending_cv:
            self._pending += 1
        self._queue.put((table_id, np.asarray(ids, np.int64),
                         np.asarray(grads, np.float32)))

    def push_sparse_param(self, table_id, ids, deltas):
        """Geo mode: accumulate local param deltas; every
        geo_need_push_nums accumulated rows, push the merged deltas."""
        if self.mode != 'geo':
            # mirror geo mode's hard error for the converse misuse: deltas
            # are NOT gradients — the server would lr-scale and sign-flip
            raise RuntimeError('push_sparse_param pushes parameter deltas '
                               'and is geo-mode only; use push_sparse_grad '
                               'for %r communicators' % self.mode)
        with self._geo_lock:
            acc = self._geo_acc.setdefault(table_id, {})
            for key, d in zip(np.asarray(ids, np.int64),
                              np.asarray(deltas, np.float32)):
                k = int(key)
                acc[k] = acc.get(k, 0) + d
            self._geo_count += len(ids)
            if self._geo_count >= self.geo_need_push_nums:
                self._geo_flush_locked()

    def _geo_flush_locked(self):
        for table_id, acc in self._geo_acc.items():
            if not acc:
                continue
            ids = np.asarray(list(acc.keys()), np.int64)
            deltas = np.stack(list(acc.values()))
            self.client.push_delta(table_id, ids, deltas)
        self._geo_acc = {}
        self._geo_count = 0

    def _send_loop(self):
        while True:
            item = self._queue.get()
            if item is None:
                return
            batch = [item]
            # opportunistically merge up to merge_size queued sends
            while len(batch) < self.merge_size:
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._queue.put(None)
                    break
                batch.append(nxt)
            by_table = {}
            for table_id, ids, grads in batch:
                by_table.setdefault(table_id, ([], []))
                by_table[table_id][0].append(ids)
                by_table[table_id][1].append(grads)
            try:
                for table_id, (id_list, g_list) in by_table.items():
                    uniq, merged = _merge_by_id(np.concatenate(id_list),
                                                np.concatenate(g_list))
                    self.client.push(table_id, uniq, merged)
            except Exception as e:  # keep the loop alive on transient RPC
                if self._send_error is None:  # errors; surface via flush()
                    self._send_error = e
            finally:
                with self._pending_cv:
                    self._pending -= len(batch)
                    self._pending_cv.notify_all()

    def flush(self, timeout=30.0):
        """Drain in-flight sends (the half-async barrier; async callers can
        use it too before save/eval)."""
        if self.mode == 'geo':
            with self._geo_lock:
                self._geo_flush_locked()
            return
        with self._pending_cv:
            ok = self._pending_cv.wait_for(lambda: self._pending == 0,
                                           timeout=timeout)
        if self._send_error is not None:
            err, self._send_error = self._send_error, None
            raise RuntimeError('communicator send loop failed; gradients '
                               'were dropped') from err
        if not ok:
            raise TimeoutError('communicator flush timed out '
                               '(%d sends pending)' % self._pending)

    barrier = flush


def AsyncCommunicator(client, **kw):
    return Communicator(client, mode='async', **kw)


def HalfAsyncCommunicator(client, **kw):
    return Communicator(client, mode='half_async', **kw)


def SyncCommunicator(client, **kw):
    return Communicator(client, mode='sync', **kw)


def GeoCommunicator(client, **kw):
    return Communicator(client, mode='geo', **kw)
