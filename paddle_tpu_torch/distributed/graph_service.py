"""Distributed graph engine service (counterpart of
paddle_tpu/distributed/graph_service.py; reference fork highlight:
distributed/service/graph_py_service.h:46,100,123 GraphPyService/
GraphPyServer/GraphPyClient over graph_brpc_{client,server}).

Per-shard C++ GraphStore (the port's native/graph_store.cc) hosted by
socket servers (same frame protocol as the PS embedding service); the
client key-shards requests by node id and merges results. API names follow
the reference so GNN training code ports directly: load_edge_file,
random_sample_neighboors, random_sample_nodes, pull_graph_list,
get_node_feat, add_graph_node, remove_graph_node (remove = tombstone).
Everything here runs on the host.

One difference from the JAX client: ids, edges and features travel as
int64 / float32 arrays on the wire, where the JAX client sends Python
lists. Both servers take either (each store call runs np.asarray over
what it gets), so the two packages' clients and servers interoperate; the
arrays keep a 128,000-row feature gather to one buffer copy each way.
"""
import socketserver
import threading

import numpy as np

from ..monitor import default_registry as _monitor_registry
from ..monitor import tracing as _tracing
from ..native.graph_store import GraphStore
from .ps.embedding_service import _send_msg, _recv_msg
from .resilience import Deadline, ResilientChannel, RetryPolicy

__all__ = ['GraphPyService', 'GraphPyServer', 'GraphPyClient']

# registered through the single-source schema table
# (monitor/telemetry.py CLIENT_OP_FAMILIES) so the committed metrics
# baseline and this module cannot drift
from ..monitor.telemetry import record_client_op_schema \
    as _record_client_op_schema

_CLIENT_FAMS = _record_client_op_schema(_monitor_registry())
_M_GRAPH_CALLS = _CLIENT_FAMS['graph_client_calls_total']
_M_GRAPH_ERRORS = _CLIENT_FAMS['graph_client_call_errors_total']

# Retry semantics of every op _GraphHandler dispatches, declared at the
# server (the JAX package's table). Same vocabulary as the embedding
# service's OP_SEMANTICS.
OP_SEMANTICS = {
    'stop': 'non_idempotent',           # second delivery hits a dead server
    # store appends duplicate on resend, UNLESS the send is journaled:
    # a (client, seq) pair lets the server dedup on its high-water mark
    'add_edges': 'conditional',         # idempotent iff journaled
    'add_nodes': 'idempotent',          # no-op on an existing node
    'remove_nodes': 'idempotent',       # tombstone: resend re-tombstones
    'load_edge_file': 'non_idempotent',  # bulk append of the same file
    'sample_neighbors': 'idempotent',   # pure read
    'random_sample_nodes': 'idempotent',  # pure read
    'pull_graph_list': 'idempotent',    # pure read
    'degree': 'idempotent',             # pure read
    'set_node_feat': 'idempotent',      # re-writes the same values
    'get_node_feat': 'idempotent',      # pure read
    'stats': 'idempotent',              # pure read
    'ping': 'idempotent',               # liveness probe, pure read
    'snapshot': 'idempotent',           # rewrites the same snapshot file
    'restore': 'idempotent',            # reloads the same snapshot file
}


def _apply_graph_write(store, entry):
    """Apply one mutation oplog entry to a store. Shared by the live
    dispatch path and snapshot restore (the GraphStore may be the
    opaque C++ backend, so snapshots persist the mutation log and
    restore replays it into a fresh store)."""
    kind = entry['kind']
    if kind == 'add_edges':
        return store.add_edges(entry['src'], entry['dst'],
                               entry.get('weight'))
    if kind == 'add_nodes':
        return store.add_nodes(entry['ids'])
    if kind == 'remove_nodes':
        return store.remove_nodes(entry['ids'])
    if kind == 'set_node_feat':
        for i, f in zip(entry['ids'], entry['feats']):
            store.set_node_feat(i, f)
        return None
    if kind == 'load_edge_file':
        return store.load_edge_file(entry['path'],
                                    entry.get('reversed', False))
    raise ValueError('unknown graph write %r' % kind)


class _GraphHandler(socketserver.BaseRequestHandler):
    def setup(self):
        # registry lets chaos.kill_server sever established connections,
        # not just the listener — a killed pod drops both
        self.server.live_connections.add(self.request)

    def finish(self):
        self.server.live_connections.discard(self.request)

    def handle(self):
        while True:
            try:
                msg = _recv_msg(self.request)
            except (ConnectionError, OSError):
                return
            # continues the client's rpc.attempt span when the message
            # carries trace context; always strips the metadata key
            span = _tracing.default_tracer().server_span(msg, 'graph.server')
            op = msg['op']
            gsrv = self.server.graph_server
            try:
                if op == 'stop':
                    _send_msg(self.request, b'ok')
                    self.server.shutdown()
                    return
                if op == 'ping':
                    _send_msg(self.request, {'ok': True,
                                             'rank': gsrv.rank})
                    continue
                if op == 'snapshot':
                    gsrv.snapshot(msg['path'])
                    _send_msg(self.request, b'ok')
                    continue
                if op == 'restore':
                    gsrv.restore(msg['path'])
                    _send_msg(self.request, b'ok')
                    continue
                # read stores fresh each request: restore() swaps the
                # whole map and long-lived connections must see the
                # rebuilt stores, not the pre-recovery ones
                store = self.server.stores[msg.get('etype', 'default')]
                if op == 'add_edges':
                    entry = {'kind': 'add_edges',
                             'etype': msg.get('etype', 'default'),
                             'src': msg['src'], 'dst': msg['dst'],
                             'weight': msg.get('weight')}
                    cid = msg.get('client')
                    if cid is not None:
                        # journaled append: dedup on the per-client seq
                        # high-water mark — exactly-once under retry
                        applied = gsrv.journal_apply(
                            cid, msg['seq'],
                            lambda: gsrv.apply_write(entry))
                        _send_msg(self.request,
                                  {'ok': True, 'applied': applied})
                    else:
                        gsrv.apply_write(entry)
                        _send_msg(self.request, b'ok')
                elif op == 'add_nodes':
                    gsrv.apply_write({'kind': 'add_nodes',
                                      'etype': msg.get('etype', 'default'),
                                      'ids': msg['ids']})
                    _send_msg(self.request, b'ok')
                elif op == 'remove_nodes':
                    _send_msg(self.request, gsrv.apply_write(
                        {'kind': 'remove_nodes',
                         'etype': msg.get('etype', 'default'),
                         'ids': msg['ids']}))
                elif op == 'load_edge_file':
                    n = gsrv.apply_write(
                        {'kind': 'load_edge_file',
                         'etype': msg.get('etype', 'default'),
                         'path': msg['path'],
                         'reversed': msg.get('reversed', False)})
                    _send_msg(self.request, n)
                elif op == 'sample_neighbors':
                    out = store.sample_neighbors(msg['ids'],
                                                 msg['sample_size'])
                    _send_msg(self.request, out)
                elif op == 'random_sample_nodes':
                    _send_msg(self.request, store.random_sample_nodes(msg['k']))
                elif op == 'pull_graph_list':
                    _send_msg(self.request,
                              store.pull_graph_list(msg['shard'],
                                                    msg['cursor'],
                                                    msg['cap']))
                elif op == 'degree':
                    _send_msg(self.request, store.degree(msg['ids']))
                elif op == 'set_node_feat':
                    gsrv.apply_write({'kind': 'set_node_feat',
                                      'etype': msg.get('etype', 'default'),
                                      'ids': msg['ids'],
                                      'feats': msg['feats']})
                    _send_msg(self.request, b'ok')
                elif op == 'get_node_feat':
                    _send_msg(self.request,
                              store.get_node_feat(msg['ids'], msg['dim']))
                elif op == 'stats':
                    _send_msg(self.request, {'nodes': store.node_count(),
                                             'edges': store.edge_count()})
                else:
                    _send_msg(self.request, {'error': 'unknown op %r' % op})
            except Exception as e:  # report instead of killing the server
                span.set_error(e)
                _send_msg(self.request, {'error': repr(e)})
            finally:
                span.finish()


class _GraphTCPServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    # rebinding the port right after a kill must not wait out TIME_WAIT:
    # restart-on-the-same-endpoint is the recovery path under test
    allow_reuse_address = True


class GraphPyServer:
    """One graph shard server (graph_brpc_server parity)."""

    def __init__(self, rank=0, host='127.0.0.1', port=0, edge_types=('default',)):
        self._srv = _GraphTCPServer((host, port), _GraphHandler)
        self._srv.stores = {et: GraphStore() for et in edge_types}
        self._srv.live_connections = set()
        self._srv.graph_server = self
        self.port = self._srv.server_address[1]
        self.rank = rank
        self._edge_types = tuple(edge_types)
        # the GraphStore may be the opaque ctypes backend, so durable
        # state is an append-only mutation log: snapshot persists it,
        # restore replays it into fresh stores. The journal holds the
        # exactly-once (client -> last applied seq) marks.
        self._oplog = []
        self._journal = {}
        # RLock: journal_apply holds it across apply_fn, and apply_fn is
        # apply_write, which re-enters to append the oplog entry
        self._state_lock = threading.RLock()

    def journal_apply(self, client_id, seq, apply_fn):
        """Apply a journaled write exactly once (mark-and-apply under
        one lock, same contract as EmbeddingServer.journal_apply).
        Returns False on a dedup hit."""
        seq = int(seq)
        with self._state_lock:
            if seq <= self._journal.get(client_id, -1):
                return False
            apply_fn()
            self._journal[client_id] = seq
            return True

    def apply_write(self, entry):
        """Apply a mutation to its store and append it to the oplog."""
        store = self._srv.stores[entry.get('etype', 'default')]
        out = _apply_graph_write(store, entry)
        with self._state_lock:
            self._oplog.append(entry)
        return out

    def snapshot(self, path):
        """Persist the mutation log + journal marks atomically (io_save:
        temp + rename + CRC manifest)."""
        from ..framework import io_save
        with self._state_lock:
            state = {'oplog': list(self._oplog),
                     'journal': dict(self._journal),
                     'edge_types': list(self._edge_types)}
        io_save.save(state, path)

    def restore(self, path):
        """Rebuild every store by replaying a snapshot's mutation log
        into fresh GraphStores, then seat its journal marks."""
        from ..framework import io_save
        state = io_save.load(path)
        stores = {et: GraphStore()
                  for et in state.get('edge_types', self._edge_types)}
        for entry in state['oplog']:
            _apply_graph_write(stores[entry.get('etype', 'default')],
                               entry)
        with self._state_lock:
            self._srv.stores = stores
            self._oplog = list(state['oplog'])
            self._journal = {str(k): int(v)
                             for k, v in state['journal'].items()}

    def start_server(self, block=False):
        if block:
            self._srv.serve_forever()
        else:
            t = threading.Thread(target=self._srv.serve_forever, daemon=True)
            t.start()

    def stop_server(self):
        self._srv.shutdown()
        self._srv.server_close()

    # ---- fleet telemetry ------------------------------------------

    def metrics_server(self, **kwargs):
        """A MetricsServer over this process's registry — start it in a
        graph shard process and add `.url` to a FleetCollector as an
        HTTP target for the federated fleet view."""
        from ..monitor.server import MetricsServer
        return MetricsServer(registry=_monitor_registry(), **kwargs)

    def fleet_register(self, collector, instance=None):
        """Register this shard on an in-process FleetCollector. Server
        metrics live on the PROCESS registry: register each process
        once (in-proc shards share the registry; registering every
        shard would double-count the merge)."""
        return collector.add_target(instance or 'graph-%d' % self.rank,
                                    registry=_monitor_registry())


class GraphPyClient:
    """Key-sharded client (graph_brpc_client parity): node id % n_servers
    selects the shard; batch ops split/merge per shard.

    Transport is a ResilientChannel per shard: socket timeouts, reconnect
    + retry for idempotent ops, circuit breaker per endpoint. add_edges
    is conditional: unjournaled, a resend after an applied-but-unacked
    write would duplicate edges, so it runs single-attempt; with
    `journal=` (a supervisor.PushJournal) each send carries a (client,
    seq) pair the server dedups on, so it retries — and replays after a
    shard restore — exactly once. Everything else retries across
    reconnects. `op_deadline` (seconds) bounds each public operation
    across all its shards and retries.
    """

    def __init__(self, endpoints, retry_policy=None, call_timeout=None,
                 op_deadline=None, journal=None):
        self._channels = [
            ResilientChannel(ep, retry_policy=retry_policy,
                             **({'call_timeout': call_timeout}
                                if call_timeout is not None else {}))
            for ep in endpoints]
        self._n = len(endpoints)
        self._op_deadline = op_deadline
        self._journal = journal

    def _deadline(self):
        return None if self._op_deadline is None \
            else Deadline(self._op_deadline)

    def _call(self, server_idx, msg, idempotent=True, deadline=None):
        op = str(msg.get('op', '?'))
        _M_GRAPH_CALLS.labels(op).inc()
        try:
            out = self._channels[server_idx].call(msg,
                                                  idempotent=idempotent,
                                                  deadline=deadline)
        except Exception:
            _M_GRAPH_ERRORS.labels(op).inc()
            raise
        if isinstance(out, dict) and 'error' in out:
            _M_GRAPH_ERRORS.labels(op).inc()
            raise RuntimeError(out['error'])
        return out

    def _shard(self, ids):
        ids = np.asarray(ids, np.int64)
        return ids, ids % self._n

    def add_graph_node(self, etype, ids, weight_list=None):
        # idempotent: adding an existing node is a no-op on the store
        ids, shard = self._shard(ids)
        dl = self._deadline()
        for s in range(self._n):
            sub = ids[shard == s]
            if len(sub):
                self._call(s, {'op': 'add_nodes', 'etype': etype,
                               'ids': sub}, deadline=dl)

    def remove_graph_node(self, etype, ids):
        # idempotent: remove is a tombstone, a resend re-tombstones
        ids, shard = self._shard(ids)
        dl = self._deadline()
        removed = 0
        for s in range(self._n):
            sub = ids[shard == s]
            if len(sub):
                removed += self._call(s, {'op': 'remove_nodes',
                                          'etype': etype,
                                          'ids': sub},
                                      deadline=dl)
        return removed

    @property
    def journal(self):
        """The PushJournal backing exactly-once sends (None when
        unjournaled) — ShardSupervisor trims it at snapshot barriers."""
        return self._journal

    def _note_applied(self, out, seq):
        """Count a server-side dedup hit on a journaled send."""
        if seq is not None and isinstance(out, dict) \
                and not out.get('applied', True):
            self._journal.note_dedup()

    def add_edges(self, etype, src, dst, weight=None):
        src, shard = self._shard(src)
        dst = np.asarray(dst, np.int64)
        w = np.asarray(weight, np.float32) if weight is not None else None
        seq = None
        if self._journal is not None:
            seq = self._journal.record({'kind': 'add_edges',
                                        'etype': etype,
                                        'src': src.copy(),
                                        'dst': dst.copy(),
                                        'weight': None if w is None
                                        else w.copy()})
        dl = self._deadline()
        for s in range(self._n):
            m = shard == s
            if m.any():
                # unjournaled appends are NOT idempotent (a blind resend
                # after an applied-but-unacked write duplicates edges);
                # journaled sends dedup server-side and may retry
                msg = {'op': 'add_edges', 'etype': etype,
                       'src': src[m], 'dst': dst[m],
                       'weight': w[m] if w is not None else None}
                if seq is not None:
                    msg['client'] = self._journal.client_id
                    msg['seq'] = seq
                out = self._call(s, msg, idempotent=seq is not None,
                                 deadline=dl)
                self._note_applied(out, seq)

    def replay_journal(self):
        """Resend every retained add_edges entry (oldest first) after a
        graph shard restart/restore; the server's journal marks make the
        replay exactly-once. Returns (entries_replayed, dedup_hits)."""
        if self._journal is None:
            return 0, 0
        before = self._journal.dedup_hits
        replayed = 0
        for seq, entry in self._journal.entries():
            src = np.asarray(entry['src'], np.int64)
            dst = np.asarray(entry['dst'], np.int64)
            w = entry.get('weight')
            w = np.asarray(w, np.float32) if w is not None else None
            shard = src % self._n
            dl = self._deadline()
            for s in range(self._n):
                m = shard == s
                if not m.any():
                    continue
                msg = {'op': 'add_edges', 'etype': entry['etype'],
                       'src': src[m], 'dst': dst[m],
                       'weight': w[m] if w is not None else None,
                       'client': self._journal.client_id, 'seq': seq}
                out = self._call(s, msg, idempotent=seq is not None,
                                 deadline=dl)
                self._note_applied(out, seq)
            replayed += 1
            self._journal.note_replay()
        return replayed, self._journal.dedup_hits - before

    def load_edge_file(self, etype, path, reversed=False):
        """Each server loads the rows whose src hashes to it; for the local
        all-in-one case, load on server 0 then re-shard via add_edges."""
        data = np.loadtxt(path, ndmin=2)
        src = data[:, 0].astype(np.int64)
        dst = data[:, 1].astype(np.int64)
        w = data[:, 2].astype(np.float32) if data.shape[1] > 2 else None
        if reversed:
            src, dst = dst, src
        self.add_edges(etype, src, dst, w)
        return len(src)

    def random_sample_neighboors(self, etype, ids, sample_size):
        # (sic) reference spells it "neighboors"
        ids, shard = self._shard(ids)
        dl = self._deadline()
        out = np.full((len(ids), sample_size), -1, np.int64)
        for s in range(self._n):
            m = shard == s
            if m.any():
                res = self._call(s, {'op': 'sample_neighbors', 'etype': etype,
                                     'ids': ids[m],
                                     'sample_size': sample_size},
                                 deadline=dl)
                out[m] = res
        return out

    sample_neighbors = random_sample_neighboors

    def random_sample_nodes(self, etype, server_idx, k):
        return self._call(server_idx % self._n,
                          {'op': 'random_sample_nodes', 'etype': etype,
                           'k': k}, deadline=self._deadline())

    def pull_graph_list(self, etype, server_idx, shard, cursor, cap):
        return self._call(server_idx % self._n,
                          {'op': 'pull_graph_list', 'etype': etype,
                           'shard': shard, 'cursor': cursor, 'cap': cap},
                          deadline=self._deadline())

    def get_node_feat(self, etype, ids, dim):
        ids, shard = self._shard(ids)
        dl = self._deadline()
        out = np.zeros((len(ids), dim), np.float32)
        for s in range(self._n):
            m = shard == s
            if m.any():
                out[m] = self._call(s, {'op': 'get_node_feat', 'etype': etype,
                                        'ids': ids[m], 'dim': dim},
                                    deadline=dl)
        return out

    def set_node_feat(self, etype, ids, feats):
        # idempotent: a resend re-writes the same feature values
        ids, shard = self._shard(ids)
        feats = np.asarray(feats, np.float32)
        dl = self._deadline()
        for s in range(self._n):
            m = shard == s
            if m.any():
                self._call(s, {'op': 'set_node_feat', 'etype': etype,
                               'ids': ids[m],
                               'feats': feats[m]}, deadline=dl)

    def get_degree(self, etype, ids):
        ids, shard = self._shard(ids)
        dl = self._deadline()
        out = np.zeros(len(ids), np.int64)
        for s in range(self._n):
            m = shard == s
            if m.any():
                out[m] = self._call(s, {'op': 'degree', 'etype': etype,
                                        'ids': ids[m]},
                                    deadline=dl)
        return out

    def stop_server(self):
        for s in range(self._n):
            try:
                # single attempt: a dead server IS the desired end state
                self._call(s, {'op': 'stop'}, idempotent=False)
            except Exception:
                pass
        self.close()

    def close(self):
        for ch in self._channels:
            ch.close()


class GraphPyService:
    """Orchestration (graph_py_service.h:46): builds a mini graph-PS cluster
    from an ip list and hands out client/server objects."""

    def __init__(self):
        self._servers = []
        self._client = None
        self._edge_types = ('default',)

    def set_up(self, ips_str=None, shard_num=None, node_types=None,
               edge_types=None, num_servers=2):
        if edge_types:
            self._edge_types = tuple(edge_types)
        self._servers = [GraphPyServer(rank=i, edge_types=self._edge_types)
                         for i in range(num_servers)]
        for s in self._servers:
            s.start_server()
        eps = ['127.0.0.1:%d' % s.port for s in self._servers]
        self._client = GraphPyClient(eps)
        return self._client

    @property
    def client(self):
        return self._client

    def stop(self):
        if self._client:
            self._client.stop_server()
            self._client = None
        for s in self._servers:
            # the 'stop' op only shuts down serve_forever; release the
            # listening socket too so repeated set_up/stop cycles don't
            # leak fds
            try:
                s.stop_server()
            except Exception:
                pass
        self._servers = []
