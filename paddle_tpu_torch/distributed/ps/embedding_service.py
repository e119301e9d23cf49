"""Host-side sharded embedding service (counterpart of
paddle_tpu/distributed/ps/embedding_service.py, the same code: the tables
and the service are host programs, so nothing here touches the card).

Reference: distributed/table/common_sparse_table.cc + service/brpc_ps_*.cc
+ framework/fleet/fleet_wrapper.h pull/push. Capability: 100B-feature
sparse embeddings that cannot live in device memory. Key-sharded hash
tables on host(s); workers pull rows for the batch's unique ids, the card
computes dense grads, workers push grads back and the server applies the
optimizer server-side (the division of labor of the reference's
DownpourWorker + CommonSparseTable).

Transport: in-process for single-host; TCP socket protocol with the typed
binary codec (wire.py, the JAX package's bytes: a port client talks to a
JAX server and the reverse) for multi-host. Server-side optimizer appliers
mirror table/depends/sparse.h (sgd/adagrad/adam).
"""
import os
import socketserver
import struct
import threading

import numpy as np

from ...monitor import default_registry as _monitor_registry
from ...monitor import tracing as _tracing
from ..resilience import Deadline, ResilientChannel, call_once

__all__ = ['EmbeddingTable', 'EmbeddingServer', 'EmbeddingClient',
           'CountFilterEntry', 'ProbabilityEntry']

# per-op RPC counters (label set is the closed op vocabulary — bounded
# cardinality; see docs/observability.md). Registered through the
# single-source schema table (monitor/telemetry.py CLIENT_OP_FAMILIES)
# so the committed metrics baseline and this module cannot drift.
from ...monitor.telemetry import record_client_op_schema \
    as _record_client_op_schema

_CLIENT_FAMS = _record_client_op_schema(_monitor_registry())
_M_PS_CALLS = _CLIENT_FAMS['ps_client_calls_total']
_M_PS_ERRORS = _CLIENT_FAMS['ps_client_call_errors_total']

# Retry semantics of every op _Handler dispatches, declared where the
# server registers them (the JAX package's table, which its graftlint
# holds against the client's send sites). Vocabulary:
# idempotent (safe to resend), accumulating (grad-style accumulation —
# clients must send idempotent=False), conditional (depends on the
# payload — clients must compute the kwarg), non_idempotent (never
# blind-resent).
OP_SEMANTICS = {
    'pull': 'idempotent',            # pure read
    # the accumulating writes are conditional: journaled sends carry a
    # (client, seq) pair the server dedups on its high-water mark, so
    # they retry safely; unjournaled sends must stay single-attempt
    'push': 'conditional',           # idempotent iff journaled
    'push_delta': 'conditional',     # idempotent iff journaled
    'pull_dense': 'idempotent',      # pure read
    'push_dense': 'conditional',     # idempotent iff journaled
    'set_dense': 'idempotent',       # last-writer set of the same value
    'barrier': 'non_idempotent',     # a resend double-arrives a worker
    'tensor': 'conditional',         # set/get resend safely; increment not
    'save': 'idempotent',            # rewrites the same shard file
    'load': 'idempotent',            # reloads the same shard file
    'ping': 'idempotent',            # liveness probe, pure read
    'snapshot': 'idempotent',        # rewrites the same snapshot file
    'restore': 'idempotent',         # reloads the same snapshot file
    'stop': 'non_idempotent',        # second delivery hits a dead server
}


class _SparseOptimizer:
    """Server-side appliers (reference: table/depends/sparse.h)."""

    def __init__(self, name='sgd', lr=0.01, beta1=0.9, beta2=0.999,
                 epsilon=1e-8):
        self.name = name
        self.lr = lr
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def slot_count(self):
        return {'sgd': 0, 'adagrad': 1, 'adam': 2}[self.name]

    def apply(self, rows, slots, grads):
        if self.name == 'sgd':
            rows -= self.lr * grads
            return rows, slots
        if self.name == 'adagrad':
            g2 = slots[0] + grads * grads
            rows -= self.lr * grads / (np.sqrt(g2) + self.epsilon)
            return rows, [g2]
        m = self.beta1 * slots[0] + (1 - self.beta1) * grads
        v = self.beta2 * slots[1] + (1 - self.beta2) * grads * grads
        rows -= self.lr * m / (np.sqrt(v) + self.epsilon)
        return rows, [m, v]


class CountFilterEntry:
    """Feature admission: materialize a row only after its id was seen
    `count` times (reference distributed/common/ entry_attr count_filter —
    keeps one-off ids from bloating 100B-feature tables)."""

    tracks_count = True

    def __init__(self, count=1):
        if count < 1:
            raise ValueError('count must be >= 1')
        self.count = int(count)

    def accept(self, seen_count, rng):
        return seen_count >= self.count


class ProbabilityEntry:
    """Feature admission with probability p (entry_attr probability) —
    memoryless, so no per-id sighting state is kept."""

    tracks_count = False

    def __init__(self, probability=1.0):
        if not 0.0 < probability <= 1.0:
            raise ValueError('probability must be in (0, 1]')
        self.probability = float(probability)

    def accept(self, seen_count, rng):
        return rng.rand() < self.probability


class EmbeddingTable:
    """One shard: id -> row. On-demand init (common_sparse_table semantics)
    with optional entry-admission policy; thread-safe; save/load to
    directory of npz chunks."""

    def __init__(self, dim, initializer='uniform', init_scale=0.01,
                 optimizer='sgd', lr=0.01, seed=0, entry=None):
        self.dim = dim
        self._rows = {}
        self._slots = {}
        self._lock = threading.Lock()
        self._rng = np.random.RandomState(seed)
        self._init_scale = init_scale
        self._initializer = initializer
        self._opt = _SparseOptimizer(optimizer, lr)
        self._entry = entry
        self._seen = {}

    def _new_row(self):
        if self._initializer == 'zeros':
            return np.zeros(self.dim, np.float32)
        return self._rng.uniform(-self._init_scale, self._init_scale,
                                 self.dim).astype(np.float32)

    def pull(self, ids):
        out = np.empty((len(ids), self.dim), np.float32)
        with self._lock:
            for i, key in enumerate(ids):
                row = self._rows.get(key)
                if row is None:
                    if self._entry is not None:
                        seen = 1
                        if getattr(self._entry, 'tracks_count', False):
                            seen = self._seen.get(key, 0) + 1
                        if not self._entry.accept(seen, self._rng):
                            # not admitted yet: serve zeros; count-based
                            # policies remember the sighting, memoryless
                            # ones keep nothing
                            if getattr(self._entry, 'tracks_count', False):
                                self._seen[key] = seen
                            out[i] = 0.0
                            continue
                        self._seen.pop(key, None)
                    row = self._new_row()
                    self._rows[key] = row
                    nslots = self._opt.slot_count()
                    if nslots:
                        self._slots[key] = [np.zeros(self.dim, np.float32)
                                            for _ in range(nslots)]
                out[i] = row
        return out

    def push(self, ids, grads):
        with self._lock:
            for key, g in zip(ids, grads):
                row = self._rows.get(key)
                if row is None:
                    continue
                slots = self._slots.get(key, [])
                new_row, new_slots = self._opt.apply(row.copy(), list(slots), g)
                self._rows[key] = new_row
                if new_slots:
                    self._slots[key] = new_slots

    def push_delta(self, ids, deltas):
        """Apply raw parameter deltas (geo-SGD sends / PSGPU end-pass
        flush): rows += delta, bypassing the server optimizer."""
        with self._lock:
            for key, d in zip(ids, deltas):
                row = self._rows.get(key)
                if row is None:
                    continue
                self._rows[key] = row + np.asarray(d, row.dtype)

    def __len__(self):
        return len(self._rows)

    def save(self, path):
        os.makedirs(path, exist_ok=True)
        with self._lock:
            keys = np.asarray(list(self._rows.keys()), np.int64)
            vals = np.stack(list(self._rows.values())) if self._rows else \
                np.zeros((0, self.dim), np.float32)
            seen_keys = np.asarray(list(self._seen.keys()), np.int64)
            seen_vals = np.asarray(list(self._seen.values()), np.int64)
        np.savez(os.path.join(path, 'shard.npz'), keys=keys, vals=vals,
                 seen_keys=seen_keys, seen_vals=seen_vals)

    def load(self, path):
        data = np.load(os.path.join(path, 'shard.npz'))
        with self._lock:
            self._rows = {int(k): v for k, v in zip(data['keys'],
                                                    data['vals'])}
            if 'seen_keys' in data:
                self._seen = {int(k): int(v) for k, v in
                              zip(data['seen_keys'], data['seen_vals'])}

    def shrink(self, threshold=0):
        pass

    def state_dict(self):
        """Full shard state for a supervisor snapshot: rows, optimizer
        slots, admission sightings AND the row-init RNG state — a
        restored shard must mint the same rows for ids it has not seen,
        or a resumed run diverges from the uninterrupted one. (For
        SsdSparseTable subclasses this covers the in-memory hot set.)"""
        with self._lock:
            return {
                'rows': {int(k): v.copy() for k, v in self._rows.items()},
                'slots': {int(k): [s.copy() for s in v]
                          for k, v in self._slots.items()},
                'seen': dict(self._seen),
                'rng': self._rng.get_state(),
            }

    def set_state_dict(self, state):
        with self._lock:
            self._rows = {int(k): np.asarray(v, np.float32)
                          for k, v in state['rows'].items()}
            self._slots = {int(k): [np.asarray(s, np.float32) for s in v]
                           for k, v in state['slots'].items()}
            self._seen = {int(k): int(v)
                          for k, v in state.get('seen', {}).items()}
            if state.get('rng') is not None:
                self._rng.set_state(state['rng'])


# -- socket RPC (multi-host path) ------------------------------------------

def _send_msg(sock, obj):
    # typed wire codec, NOT pickle: unpickling peer bytes would be
    # remote code execution by design (see wire.py)
    from . import wire
    payload = wire.encode(obj)
    sock.sendall(struct.pack('>Q', len(payload)) + payload)


def _recv_msg(sock):
    hdr = b''
    while len(hdr) < 8:
        chunk = sock.recv(8 - len(hdr))
        if not chunk:
            raise ConnectionError('peer closed')
        hdr += chunk
    n = struct.unpack('>Q', hdr)[0]
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError('peer closed')
        buf.extend(chunk)
    from . import wire
    return wire.decode(bytes(buf))


def _apply_table_write(server, op, msg):
    """Apply one accumulating write message to its table (shared by the
    direct dispatch path and the journaled exactly-once path)."""
    if op == 'push':
        server.table(msg['table']).push(msg['ids'], msg['grads'])
    elif op == 'push_delta':
        server.table(msg['table']).push_delta(msg['ids'], msg['deltas'])
    else:
        server.table(msg['table']).push(msg['grad'])


class _Handler(socketserver.BaseRequestHandler):
    def setup(self):
        # registry lets chaos.kill_server sever established connections,
        # not just the listener — a killed pod drops both
        self.server.live_connections.add(self.request)

    def finish(self):
        self.server.live_connections.discard(self.request)

    def handle(self):
        server = self.server.embedding_server
        while True:
            try:
                msg = _recv_msg(self.request)
            except (ConnectionError, OSError):
                return
            # continues the client's rpc.attempt span when the message
            # carries trace context; always strips the metadata key
            span = _tracing.default_tracer().server_span(msg, 'ps.server')
            try:
                op = msg['op']
                if op == 'pull':
                    out = server.table(msg['table']).pull(msg['ids'])
                    _send_msg(self.request, out)
                elif op in ('push', 'push_delta', 'push_dense'):
                    cid = msg.get('client')
                    if cid is not None:
                        # journaled write: dedup on the per-client seq
                        # high-water mark so a retried/replayed push
                        # applies exactly once
                        applied = server.journal_apply(
                            cid, msg['seq'],
                            lambda: _apply_table_write(server, op, msg))
                        _send_msg(self.request,
                                  {'ok': True, 'applied': applied})
                    else:
                        _apply_table_write(server, op, msg)
                        _send_msg(self.request, b'ok')
                elif op == 'pull_dense':
                    _send_msg(self.request,
                              server.table(msg['table']).pull())
                elif op == 'set_dense':
                    server.table(msg['table']).set(msg['value'])
                    _send_msg(self.request, b'ok')
                elif op == 'barrier':
                    server.table(msg['table']).barrier(
                        msg.get('worker_id'), msg.get('timeout', 60.0))
                    _send_msg(self.request, b'ok')
                elif op == 'tensor':
                    if msg['method'] not in ('set', 'get', 'increment'):
                        raise ValueError('bad tensor method %r'
                                         % msg['method'])
                    tt = server.table(msg['table'])
                    method = getattr(tt, msg['method'])
                    _send_msg(self.request, method(*msg.get('args', ())))
                elif op == 'save':
                    server.table(msg['table']).save(msg['path'])
                    _send_msg(self.request, b'ok')
                elif op == 'load':
                    server.table(msg['table']).load(msg['path'])
                    _send_msg(self.request, b'ok')
                elif op == 'ping':
                    _send_msg(self.request, {'ok': True,
                                             'port': server.port})
                elif op == 'snapshot':
                    server.snapshot(msg['path'])
                    _send_msg(self.request, b'ok')
                elif op == 'restore':
                    server.restore(msg['path'])
                    _send_msg(self.request, b'ok')
                elif op == 'stop':
                    _send_msg(self.request, b'ok')
                    self.server.shutdown()
                    return
                else:
                    _send_msg(self.request, {'error': 'unknown op %r' % op})
            except Exception as e:  # report instead of killing the server
                span.set_error(e)
                try:
                    _send_msg(self.request, {'error': repr(e)})
                except OSError:
                    return
            finally:
                span.finish()


class _PsTCPServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    # restart-on-the-same-endpoint is the recovery path: rebinding right
    # after a kill must not wait out TIME_WAIT
    allow_reuse_address = True


class EmbeddingServer:
    """One PS shard process (BrpcPsServer parity, socket transport)."""

    def __init__(self, host='127.0.0.1', port=0):
        self._tables = {}
        self._srv = _PsTCPServer((host, port), _Handler,
                                 bind_and_activate=True)
        self._srv.embedding_server = self
        self._srv.live_connections = set()
        self.port = self._srv.server_address[1]
        self.endpoint = '%s:%d' % (host, self.port)
        self._thread = None
        # exactly-once dedup state: client_id -> last applied seq.
        # Included in snapshot()/restore() so a replayed journal after a
        # restore is judged against the restored state, not a blank one.
        self._journal = {}
        self._journal_lock = threading.Lock()

    def create_table(self, table_id, dim, table_class=None, backend=None,
                     **kwargs):
        if backend == 'native':
            if table_class is not None:
                raise ValueError('pass either table_class or '
                                 "backend='native', not both")
            from ...native.embedding_table import NativeEmbeddingTable
            cls = NativeEmbeddingTable
        else:
            cls = table_class or EmbeddingTable
        self._tables[table_id] = cls(dim, **kwargs)
        return self._tables[table_id]

    def create_dense_table(self, table_id, shape, **kwargs):
        from .tables import DenseTable
        self._tables[table_id] = DenseTable(shape, **kwargs)
        return self._tables[table_id]

    def create_barrier_table(self, table_id, trigger_count):
        from .tables import BarrierTable
        self._tables[table_id] = BarrierTable(trigger_count)
        return self._tables[table_id]

    def create_tensor_table(self, table_id):
        from .tables import TensorTable
        self._tables[table_id] = TensorTable()
        return self._tables[table_id]

    def table(self, table_id):
        return self._tables[table_id]

    def journal_apply(self, client_id, seq, apply_fn):
        """Apply a journaled write exactly once. The mark-and-apply runs
        under one lock so a duplicate arriving on a second connection
        (client reconnected and resent before the first handler thread
        finished) can never double-apply. Returns False on a dedup hit."""
        seq = int(seq)
        with self._journal_lock:
            if seq <= self._journal.get(client_id, -1):
                return False
            apply_fn()
            self._journal[client_id] = seq
            return True

    def state_dict(self):
        """Snapshot every table that supports it (BarrierTable holds
        only transient arrival counts and is deliberately skipped) plus
        the exactly-once journal marks. Caller holds _journal_lock."""
        tables = {}
        for tid, table in self._tables.items():
            state_fn = getattr(table, 'state_dict', None)
            if state_fn is not None:
                tables[tid] = state_fn()
        return {'tables': tables, 'journal': dict(self._journal)}

    def snapshot(self, path):
        """Write the full shard state atomically (io_save: temp + rename
        + CRC manifest). Held under the journal lock so journaled pushes
        serialize against the snapshot — the journal marks in the file
        exactly vouch for the table state next to them."""
        from ...framework import io_save
        with self._journal_lock:
            state = self.state_dict()
        io_save.save(state, path)

    def restore(self, path):
        """Load a snapshot() file into the (already created) tables."""
        from ...framework import io_save
        state = io_save.load(path)
        for tid, table_state in state['tables'].items():
            self._tables[tid].set_state_dict(table_state)
        with self._journal_lock:
            self._journal = {str(k): int(v)
                             for k, v in state['journal'].items()}

    def start(self, block=False):
        if block:
            self._srv.serve_forever()
        else:
            self._thread = threading.Thread(target=self._srv.serve_forever,
                                            daemon=True)
            self._thread.start()

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()

    # ---- fleet telemetry ------------------------------------------

    def metrics_server(self, **kwargs):
        """A MetricsServer over this process's registry — start it in a
        PS shard process and add `.url` to a FleetCollector as an HTTP
        target; the shard's ps_server_* families then show up in the
        federated view with the shard's instance label."""
        from ...monitor.server import MetricsServer
        return MetricsServer(registry=_monitor_registry(), **kwargs)

    def fleet_register(self, collector, instance=None):
        """Register this shard on an in-process FleetCollector (same
        process, no HTTP hop). Server metrics live on the PROCESS
        registry, so register each process once — two in-proc shards
        share one registry and registering both would double-count."""
        return collector.add_target(instance or 'ps-%d' % self.port,
                                    registry=_monitor_registry())


class EmbeddingClient:
    """Key-sharded client over N servers (BrpcPsClient parity): shard by
    id % nshards, batch per-shard, parallel requests.

    Remote transport is a ResilientChannel per shard (socket timeouts,
    reconnect + retry for idempotent ops, per-endpoint circuit breaker).
    Reads (pull/pull_dense/tensor-get) and overwrites (set_dense) retry
    transparently. Grad applications (push/push_delta/push_dense) are
    conditional: without a journal the server may have applied an unacked
    op and a resend would double-apply, so they run single-attempt and
    surface a RetryableError; with `journal=` (a supervisor.PushJournal)
    every write carries a (client, seq) pair the server dedups on, so
    they retry — and replay after a shard restore — exactly once.
    `op_deadline` (seconds) bounds each public op across all shards and
    retries.
    """

    def __init__(self, endpoints=None, servers=None, retry_policy=None,
                 call_timeout=None, op_deadline=None, journal=None):
        self._local = servers  # in-proc mode: list of EmbeddingServer
        self._channels = None
        self._endpoints = endpoints
        self._op_deadline = op_deadline
        self._journal = journal if servers is None else None
        if endpoints and not servers:
            kw = {} if call_timeout is None else \
                {'call_timeout': call_timeout}
            self._channels = [ResilientChannel(ep,
                                               retry_policy=retry_policy,
                                               **kw)
                              for ep in endpoints]
        self._n = len(servers or endpoints)

    def _shard(self, ids):
        ids = np.asarray(ids, np.int64)
        shard_idx = ids % self._n
        return ids, shard_idx

    def _deadline(self):
        return None if self._op_deadline is None \
            else Deadline(self._op_deadline)

    def _call(self, s, msg, idempotent=True, deadline=None):
        """Remote call to server s with error propagation."""
        op = str(msg.get('op', '?'))
        _M_PS_CALLS.labels(op).inc()
        try:
            out = self._channels[s].call(msg, idempotent=idempotent,
                                         deadline=deadline)
        except Exception:
            _M_PS_ERRORS.labels(op).inc()
            raise
        if isinstance(out, dict) and 'error' in out:
            _M_PS_ERRORS.labels(op).inc()
            raise RuntimeError(out['error'])
        return out

    def _call_fresh(self, s, msg, timeout=None):
        """Blocking RPC (e.g. barrier) over a NEW ephemeral connection so
        the persistent per-server channel stays free for fast ops."""
        op = str(msg.get('op', '?'))
        _M_PS_CALLS.labels(op).inc()
        kw = {} if timeout is None else {'timeout': timeout}
        try:
            out = call_once(self._endpoints[s], msg, **kw)
        except Exception:
            _M_PS_ERRORS.labels(op).inc()
            raise
        if isinstance(out, dict) and 'error' in out:
            _M_PS_ERRORS.labels(op).inc()
            raise RuntimeError(out['error'])
        return out

    def pull(self, table_id, ids):
        ids, shard_idx = self._shard(ids)
        dl = self._deadline()
        out = np.empty((len(ids), self._dim(table_id)), np.float32)
        for s in range(self._n):
            mask = shard_idx == s
            if not mask.any():
                continue
            sub = ids[mask]
            if self._local is not None:
                rows = self._local[s].table(table_id).pull(sub.tolist())
            else:
                rows = self._call(s, {'op': 'pull', 'table': table_id,
                                      'ids': sub.tolist()}, deadline=dl)
            out[mask] = rows
        return out

    @property
    def journal(self):
        """The PushJournal backing exactly-once sends (None when
        unjournaled) — ShardSupervisor trims it at snapshot barriers."""
        return self._journal

    def _record(self, kind, table_id, ids, data):
        """Journal one write before sending; returns its seq (or None
        when unjournaled). Entries are retained until the journal is
        trimmed at a snapshot barrier, so they can replay after a shard
        restore."""
        if self._journal is None:
            return None
        return self._journal.record({'kind': kind, 'table': table_id,
                                     'ids': ids, 'data': data})

    def _note_applied(self, out, seq):
        """Count a server-side dedup hit (retried/replayed journaled
        write the server had already applied)."""
        if seq is not None and isinstance(out, dict) \
                and not out.get('applied', True):
            self._journal.note_dedup()

    def push(self, table_id, ids, grads):
        ids, shard_idx = self._shard(ids)
        grads = np.asarray(grads, np.float32)
        dl = self._deadline()
        seq = self._record('push', table_id, ids.tolist(), grads)
        for s in range(self._n):
            mask = shard_idx == s
            if not mask.any():
                continue
            if self._local is not None:
                self._local[s].table(table_id).push(ids[mask].tolist(),
                                                    grads[mask])
            else:
                # unjournaled grad application is not idempotent: no
                # blind resend; journaled sends dedup server-side
                msg = {'op': 'push', 'table': table_id,
                       'ids': ids[mask].tolist(), 'grads': grads[mask]}
                if seq is not None:
                    msg['client'] = self._journal.client_id
                    msg['seq'] = seq
                out = self._call(s, msg, idempotent=seq is not None,
                                 deadline=dl)
                self._note_applied(out, seq)

    def _dim(self, table_id):
        if self._local is not None:
            return self._local[0].table(table_id).dim
        # remote: pull a probe row
        row = self._call(0, {'op': 'pull', 'table': table_id, 'ids': [0]})
        return row.shape[1]

    def push_delta(self, table_id, ids, deltas):
        """Geo-SGD path: add parameter deltas on the server."""
        ids, shard_idx = self._shard(ids)
        deltas = np.asarray(deltas, np.float32)
        dl = self._deadline()
        seq = self._record('push_delta', table_id, ids.tolist(), deltas)
        for s in range(self._n):
            mask = shard_idx == s
            if not mask.any():
                continue
            if self._local is not None:
                self._local[s].table(table_id).push_delta(
                    ids[mask].tolist(), deltas[mask])
            else:
                msg = {'op': 'push_delta', 'table': table_id,
                       'ids': ids[mask].tolist(), 'deltas': deltas[mask]}
                if seq is not None:
                    msg['client'] = self._journal.client_id
                    msg['seq'] = seq
                out = self._call(s, msg, idempotent=seq is not None,
                                 deadline=dl)
                self._note_applied(out, seq)

    def replay_journal(self):
        """Resend every retained journal entry (oldest first) after a
        shard restart/restore. The servers' journal marks decide per
        entry: writes lost with the crash re-apply, survivors dedup —
        the sum is exactly-once relative to the restored state. Returns
        (entries_replayed, dedup_hits counted during the replay)."""
        if self._journal is None:
            return 0, 0
        before = self._journal.dedup_hits
        replayed = 0
        for seq, entry in self._journal.entries():
            self._replay_entry(seq, entry)
            replayed += 1
            self._journal.note_replay()
        return replayed, self._journal.dedup_hits - before

    def _replay_entry(self, seq, entry):
        kind, table_id = entry['kind'], entry['table']
        data = np.asarray(entry['data'], np.float32)
        dl = self._deadline()
        if kind == 'push_dense':
            msg = {'op': 'push_dense', 'table': table_id, 'grad': data,
                   'client': self._journal.client_id, 'seq': seq}
            out = self._call(self._owner(table_id), msg,
                             idempotent=seq is not None, deadline=dl)
            self._note_applied(out, seq)
            return
        key = 'grads' if kind == 'push' else 'deltas'
        ids, shard_idx = self._shard(entry['ids'])
        for s in range(self._n):
            mask = shard_idx == s
            if not mask.any():
                continue
            msg = {'op': kind, 'table': table_id,
                   'ids': ids[mask].tolist(), key: data[mask],
                   'client': self._journal.client_id, 'seq': seq}
            out = self._call(s, msg, idempotent=seq is not None,
                             deadline=dl)
            self._note_applied(out, seq)

    # -- dense / barrier / tensor tables (placed by table_id % n) -----------
    def _owner(self, table_id):
        return int(table_id) % self._n

    def pull_dense(self, table_id):
        s = self._owner(table_id)
        if self._local is not None:
            return self._local[s].table(table_id).pull()
        return self._call(s, {'op': 'pull_dense', 'table': table_id},
                          deadline=self._deadline())

    def push_dense(self, table_id, grad):
        s = self._owner(table_id)
        if self._local is not None:
            return self._local[s].table(table_id).push(grad)
        grad = np.asarray(grad, np.float32)
        seq = self._record('push_dense', table_id, None, grad)
        # unjournaled grad application is not idempotent: no blind resend
        msg = {'op': 'push_dense', 'table': table_id, 'grad': grad}
        if seq is not None:
            msg['client'] = self._journal.client_id
            msg['seq'] = seq
        out = self._call(s, msg, idempotent=seq is not None,
                         deadline=self._deadline())
        self._note_applied(out, seq)

    def set_dense(self, table_id, value):
        s = self._owner(table_id)
        if self._local is not None:
            return self._local[s].table(table_id).set(value)
        # overwrite semantics: a resend re-writes the same value
        self._call(s, {'op': 'set_dense', 'table': table_id,
                       'value': np.asarray(value, np.float32)},
                   deadline=self._deadline())

    def barrier(self, table_id, worker_id=None, timeout=60.0):
        s = self._owner(table_id)
        if self._local is not None:
            return self._local[s].table(table_id).barrier(worker_id,
                                                          timeout)
        # ephemeral connection: a blocking barrier must not pin the shared
        # per-server channel (other threads' pulls/pushes keep flowing).
        # Transport timeout = barrier timeout + slack, so a wedged server
        # surfaces as a socket timeout instead of a hang.
        self._call_fresh(s, {'op': 'barrier', 'table': table_id,
                             'worker_id': worker_id, 'timeout': timeout},
                         timeout=timeout + 10.0)

    def tensor(self, table_id, method, *args):
        s = self._owner(table_id)
        if self._local is not None:
            return getattr(self._local[s].table(table_id), method)(*args)
        # set/get re-send safely; increment would double-count
        return self._call(s, {'op': 'tensor', 'table': table_id,
                              'method': method, 'args': args},
                          idempotent=(method != 'increment'),
                          deadline=self._deadline())

    def save(self, table_id, path):
        dl = self._deadline()
        for s in range(self._n):
            p = os.path.join(path, 'shard_%d' % s)
            if self._local is not None:
                self._local[s].table(table_id).save(p)
            else:
                self._call(s, {'op': 'save', 'table': table_id, 'path': p},
                           deadline=dl)
