"""ReplicaWorker: one engine behind a socket, spawnable as a process
(counterpart of paddle_tpu/serving/fabric/worker.py).

The worker owns exactly what InprocReplica owned — an engine (or a
multi-model ModelHost), a drive loop, a lifecycle state — but serves
it over the fabric wire protocol (protocol.py) so the gateway's
SocketReplica proxy can live in another process:

    python -m paddle_tpu_torch.serving.fabric.worker --preset gpt-nano \
        --device cpu --port-file w0.json

    python -m paddle_tpu_torch.serving.fabric.worker \
        --artifacts HOST:PORT --cache DIR --model m --version v1 \
        --fingerprint 0123abcd...   # content identity, verified on pull

Design rules inherited from the PS services (embedding_service.py):

- every op's retry semantics are declared in OP_SEMANTICS (the
  reference lint-enforces the table against the dispatch);
- 'submit' is the one conditional op: the client journals every send
  with a (client, seq) pair and the worker dedups on it, so a retried
  submit admits exactly once and returns the SAME req_id — the
  exactly-once discipline of journaled PS pushes applied to requests;
- the handler continues the client's rpc.attempt span via
  server_span(msg, 'fabric.worker'), so a gateway-side trace walks
  route -> rpc.call -> rpc.attempt -> fabric.worker.submit across the
  process boundary;
- engines run with emit_event=False: the GATEWAY emits the one
  canonical wide event per request; the worker reports the engine-side
  stat fields (admit_t, prefill chunks, prefix hits, spec counts, KV
  page-seconds) in the final poll reply so that event is as rich as
  the in-proc one. admit_t rides as a raw time.monotonic() value —
  CLOCK_MONOTONIC is system-wide per boot on Linux, so gateway-side
  deltas against it are meaningful.

Lifecycle: /readyz on the worker's MetricsServer flips 503 the moment
a 'drain' op lands (state -> draining) while /healthz stays 200 — the
same drain-must-not-restart-the-pod split the in-proc replica has.

Device and dtype: the worker builds its model on the card unless
`--device cpu` is given (framework/device.py: with no GPU the default
raises); `--dtype bfloat16` casts it for the card's throughput runs. The
drive thread enters torch.no_grad (grad mode is thread-local). A worker
launches no kernel (the engines' attention is always masked), so it never
builds one; were it to, `_build.py` writes each library to a temporary
file and renames it, so two processes building at once cannot tear it.
"""
import argparse
import json
import os
import socketserver
import sys
import threading
import time

import torch

from ...distributed.resilience import FrameError
from ...monitor import default_registry as _default_registry
from ...monitor import tracing as _tracing
from .protocol import recv_frame, send_frame
from .transport import DEAD, DRAINING, READY, STOPPED

__all__ = ['ReplicaWorker', 'WorkerHandle', 'spawn_worker', 'main',
           'OP_SEMANTICS']

# the directory holding paddle_tpu_torch/ (a spawned worker imports from it)
_PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

# retry semantics per op (the reference lint-enforces this table):
OP_SEMANTICS = {
    # journaled admission: the (client, seq) pair dedups a retried send
    # server-side, so journaled submits retry safely; an unjournaled
    # submit must stay single-attempt
    'submit': 'conditional',         # idempotent iff journaled
    'poll': 'idempotent',            # pure read at explicit offsets
    'status': 'idempotent',          # pure read
    'drain': 'idempotent',           # re-drain of a draining worker: no-op
    'rollout_prepare': 'idempotent',  # load+pin: re-pin is refcount-safe
    'rollout_finish': 'idempotent',  # unpin floors at zero
    'set_serving': 'idempotent',     # last-writer set of the same version
    'serving_version': 'idempotent',  # pure read
    'hosts_model': 'idempotent',     # pure read
    'ping': 'idempotent',            # liveness probe, pure read
    'stop': 'non_idempotent',        # second delivery hits a dead server
}


def _final_record(req):
    """Engine-side instrumentation of a finished request, shipped in
    the final poll reply so the gateway's wide event carries the same
    fields an in-proc replica would have handed it."""
    return {'outcome': getattr(req, 'outcome', None),
            'admit_t': getattr(req, '_admit_t', None),
            'arrival_t': getattr(req, '_arrival_t', None),
            'prefill_chunks': getattr(req, '_prefill_chunks', 0),
            'prefix_hit': getattr(req, '_prefix_hit', 0),
            'spec_proposed': getattr(req, '_spec_proposed', 0),
            'spec_accepted': getattr(req, '_spec_accepted', 0),
            'kv_page_seconds': getattr(req, 'kv_page_seconds', 0.0)}


class _Handler(socketserver.BaseRequestHandler):
    def setup(self):
        self.server.live_connections.add(self.request)

    def finish(self):
        self.server.live_connections.discard(self.request)

    def handle(self):
        worker = self.server.replica_worker
        while True:
            try:
                msg = recv_frame(self.request)
            except FrameError as e:
                # typed reject for a malformed/oversized frame, then
                # close: framing may be out of sync, so guessing at the
                # next header would misparse everything after it
                try:
                    send_frame(self.request,
                               {'error': repr(e),
                                'error_type': type(e).__name__})
                except OSError:
                    pass
                return
            except (ConnectionError, OSError):
                return
            if msg is None:
                return
            span = _tracing.default_tracer().server_span(
                msg, 'fabric.worker')
            try:
                op = msg.get('op')
                if op == 'submit':
                    out = worker.op_submit(msg)
                elif op == 'poll':
                    out = worker.op_poll(msg)
                elif op == 'status':
                    out = worker.op_status()
                elif op == 'drain':
                    out = worker.op_drain()
                elif op == 'rollout_prepare':
                    out = worker.op_rollout_prepare(msg)
                elif op == 'rollout_finish':
                    out = worker.op_rollout_finish(msg)
                elif op == 'set_serving':
                    out = worker.op_set_serving(msg)
                elif op == 'serving_version':
                    out = worker.op_serving_version(msg)
                elif op == 'hosts_model':
                    out = worker.op_hosts_model(msg)
                elif op == 'ping':
                    out = {'ok': True, 'state': worker.state}
                elif op == 'stop':
                    send_frame(self.request, {'ok': True})
                    worker.stop(from_wire=True)
                    return
                else:
                    out = {'error': 'unknown op %r' % op,
                           'error_type': 'ValueError'}
                send_frame(self.request, out)
            except Exception as e:  # report instead of killing the server
                span.set_error(e)
                try:
                    send_frame(self.request,
                               {'error': repr(e),
                                'error_type': type(e).__name__})
                except OSError:
                    return
            finally:
                span.finish()


class _WorkerTCPServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


class ReplicaWorker:
    """One engine (or ModelHost) served over the fabric protocol.

    Usable in-process for tests (`ReplicaWorker(engine).start()`) and
    as the body of a spawned worker process (`main()`)."""

    def __init__(self, engine, host='127.0.0.1', port=0, metrics_port=0,
                 artifact_client=None):
        self.engine = engine
        self.state = READY
        self._artifacts = artifact_client
        self._requests = {}     # wire req id (str) -> live engine Request
        self._retired = {}      # wire req id (str) -> final reply payload
        self._journal = {}      # client id -> (last seq, last req id)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._stopping = False
        self._srv = _WorkerTCPServer((host, port), _Handler,
                                     bind_and_activate=True)
        self._srv.replica_worker = self
        self._srv.live_connections = set()
        self.port = self._srv.server_address[1]
        self.endpoint = '%s:%d' % (host, self.port)
        # /readyz flips 503 the moment drain lands; /metrics.json is the
        # federation scrape the gateway registers via scrape_kwargs()
        from ...monitor.server import MetricsServer
        self._metrics = MetricsServer(registry=_default_registry(),
                                      host=host, port=metrics_port,
                                      readiness=self.ready)
        self.metrics_url = None
        self._srv_thread = None
        self._drive_thread = None

    # ---- ops (handler thread) -----------------------------------------

    def op_submit(self, msg):
        client, seq = msg.get('client'), msg.get('seq')
        with self._lock:
            if self.state != READY:
                return {'error': 'worker is %s — not admitting' % self.state,
                        'error_type': 'RuntimeError'}
            if client is not None and seq is not None:
                last = self._journal.get(client)
                if last is not None and seq <= last[0]:
                    if seq == last[0]:
                        # duplicate delivery of the in-flight send:
                        # exactly-once means same answer, no re-admit
                        return {'req_id': last[1], 'dup': True,
                                'load': self._load_info()}
                    return {'error': 'stale seq %r <= %r' % (seq, last[0]),
                            'error_type': 'ValueError'}
        # admission outside the worker lock: the engine has its own
        # front-door lock, and ValueError (inadmissible) must propagate
        # as the typed reply, not poison the journal
        req = self.engine.add_request(msg['prompt'], emit_event=False,
                                      **msg.get('sampling', {}))
        rid = str(req.id)
        with self._lock:
            self._requests[rid] = req
            if client is not None and seq is not None:
                self._journal[client] = (seq, rid)
            self._cv.notify_all()
        return {'req_id': rid, 'dup': False, 'load': self._load_info()}

    def op_poll(self, msg):
        with self._lock:
            for rid in msg.get('ack', ()):
                self._retired.pop(rid, None)
            reply = {}
            for rid, offset in msg.get('reqs', {}).items():
                offset = int(offset)
                req = self._requests.get(rid)
                if req is not None and req.done:
                    # retire: freeze the final record so a RETRIED poll
                    # (idempotent) returns the same answer even after
                    # the engine recycles the request
                    rec = _final_record(req)
                    rec['tokens_all'] = [int(t) for t in req.tokens]
                    self._retired[rid] = rec
                    del self._requests[rid]
                    req = None
                    done_rec = rec
                else:
                    done_rec = self._retired.get(rid)
                if req is not None:
                    reply[rid] = {'tokens': [int(t) for t in
                                             req.tokens[offset:]],
                                  'done': False}
                elif done_rec is not None:
                    entry = {k: v for k, v in done_rec.items()
                             if k != 'tokens_all'}
                    entry['tokens'] = done_rec['tokens_all'][offset:]
                    entry['done'] = True
                    reply[rid] = entry
                else:
                    reply[rid] = {'unknown': True, 'tokens': [],
                                  'done': True, 'outcome': 'error'}
        return {'reqs': reply, 'load': self._load_info()}

    def op_status(self):
        return {'ok': True, 'state': self.state, 'pid': os.getpid(),
                'multi_model': hasattr(self.engine, 'prepare_rollout'),
                'load': self._load_info()}

    def op_drain(self):
        self._drain()
        return {'ok': True, 'state': self.state}

    def _host(self):
        eng = self.engine
        if not hasattr(eng, 'prepare_rollout'):
            raise RuntimeError('worker engine is single-model (no '
                               'ModelHost) — rollout ops unavailable')
        return eng

    def op_rollout_prepare(self, msg):
        host = self._host()
        model, version = msg['model'], msg['version']
        if (model, version) not in host.registry:
            if self._artifacts is None:
                raise KeyError('version (%r, %r) not in local registry '
                               'and no artifact source configured'
                               % (model, version))
            self._artifacts.ensure(host.registry, model, version)
        info = host.prepare_rollout(model, version)
        return {k: info[k] for k in ('cache_hits', 'cache_misses',
                                     'load_s') if k in info}

    def op_rollout_finish(self, msg):
        self._host().finish_rollout(msg['model'], msg.get('old_version'))
        return {'ok': True}

    def op_set_serving(self, msg):
        prev = self._host().registry.set_serving(msg['model'],
                                                 msg['version'])
        return {'prev': prev}

    def op_serving_version(self, msg):
        return {'version':
                self._host().registry.serving_version(msg['model'])}

    def op_hosts_model(self, msg):
        return {'hosts': bool(self._host().hosts_model(
            msg['model'], msg.get('version')))}

    def _load_info(self):
        eng = self.engine
        reg = _default_registry()
        occ = reg.get('serving_occupancy')
        return {'state': self.state,
                'queue_depth': len(eng.scheduler.queue),
                'pending': int(eng.scheduler.pending),
                'occupancy': 0.0 if occ is None else float(occ.value()),
                'num_slots': int(getattr(eng, 'num_slots', 1))}

    # ---- lifecycle -----------------------------------------------------

    def ready(self):
        return self.state == READY

    def _drain(self):
        with self._lock:
            if self.state == READY:
                self.state = DRAINING
        # engine.shutdown() stops admissions, finishes in-flight decode
        self.engine.shutdown()
        with self._lock:
            self._cv.notify_all()

    def start(self):
        self._srv_thread = threading.Thread(target=self._srv.serve_forever,
                                            daemon=True)
        self._srv_thread.start()
        self._metrics.start()
        self.metrics_url = self._metrics.url
        self._drive_thread = threading.Thread(target=self._drive,
                                              name='fabric-worker-drive',
                                              daemon=True)
        self._drive_thread.start()
        return self

    def _drive(self):
        with torch.no_grad():
            self._drive_loop()

    def _drive_loop(self):
        eng = self.engine
        while True:
            with self._lock:
                while not self._stopping and not eng.scheduler.pending:
                    if self.state == DRAINING:
                        # drained empty: the ladder's terminal rung. The
                        # TCP server stays up — finished-but-unpolled
                        # requests remain answerable until acked.
                        self.state = STOPPED
                        return
                    self._cv.wait(0.02)
                if self._stopping:
                    return
            try:
                eng.step()
            except Exception:   # noqa: BLE001 — engine death is terminal
                with self._lock:
                    self.state = DEAD
                return

    def stop(self, from_wire=False):
        with self._lock:
            self._stopping = True
            if self.state in (READY, DRAINING):
                self.state = STOPPED
            self._cv.notify_all()
        if from_wire:
            # shutdown() from inside a handler thread deadlocks the
            # serve_forever loop on some platforms; detach it
            threading.Thread(target=self._srv.shutdown,
                             daemon=True).start()
        else:
            self._srv.shutdown()
        self._srv.server_close()
        self._metrics.stop()
        try:
            self.engine.shutdown()
        except Exception:   # noqa: BLE001 — already dead is fine
            pass

    def wait(self):
        """Block until the TCP server exits (the 'stop' op, typically)."""
        if self._srv_thread is not None:
            self._srv_thread.join()


# ---- process entry point ---------------------------------------------


def _build_engine_from_args(args):
    from .presets import build_engine, host_factory
    dev = dict(device=args.device, dtype=args.dtype)
    if args.artifacts:
        if not (args.model and args.version and args.cache):
            raise SystemExit('--artifacts needs --model, --version and '
                             '--cache')
        from ..registry.hosting import ModelHost
        from ..registry.registry import ModelRegistry
        from .artifacts import ArtifactClient, ArtifactVerifyError
        registry = ModelRegistry(root=args.cache)
        client = ArtifactClient(args.artifacts, args.cache)
        entry = client.ensure(registry, args.model, args.version)
        if args.fingerprint and entry.fingerprint != args.fingerprint:
            raise ArtifactVerifyError(
                'pulled (%r, %r) has fingerprint %s, expected %s'
                % (args.model, args.version, entry.fingerprint,
                   args.fingerprint))
        host = ModelHost(registry, host_factory(args.preset, **dev),
                         default_model=args.model)
        return host, client
    if args.preset:
        return build_engine(args.preset, **dev), None
    raise SystemExit('need --preset or --artifacts/--model/--version')


def main(argv=None):
    p = argparse.ArgumentParser(
        prog='python -m paddle_tpu_torch.serving.fabric.worker',
        description='Serving fabric replica worker process')
    p.add_argument('--preset', default=None,
                   help='predictor-zoo preset name (presets.PRESETS)')
    p.add_argument('--artifacts', default=None,
                   help='ArtifactServer endpoint host:port to pull from')
    p.add_argument('--cache', default=None,
                   help='local artifact cache / registry root directory')
    p.add_argument('--model', default=None)
    p.add_argument('--version', default=None)
    p.add_argument('--fingerprint', default=None,
                   help='expected content fingerprint of the artifact')
    p.add_argument('--device', default='cuda',
                   help="torch device of the model ('cpu' to run without "
                        'a GPU)')
    p.add_argument('--dtype', default=None,
                   help='cast the model to this dtype (e.g. bfloat16)')
    p.add_argument('--host', default='127.0.0.1')
    p.add_argument('--port', type=int, default=0)
    p.add_argument('--metrics-port', type=int, default=0)
    p.add_argument('--port-file', default=None,
                   help='write bound endpoints here as JSON (atomic)')
    args = p.parse_args(argv)

    engine, client = _build_engine_from_args(args)
    worker = ReplicaWorker(engine, host=args.host, port=args.port,
                           metrics_port=args.metrics_port,
                           artifact_client=client)
    worker.start()
    if args.port_file:
        from ...framework.io_save import write_bytes_atomic
        write_bytes_atomic(args.port_file, json.dumps(
            {'endpoint': worker.endpoint,
             'metrics_url': worker.metrics_url,
             'pid': os.getpid()}).encode('utf-8'))
    worker.wait()
    return 0


# ---- parent-side spawn helper ----------------------------------------


class WorkerHandle:
    """A spawned worker process + its bound endpoints."""

    def __init__(self, proc, endpoint, metrics_url, port_file):
        self.proc = proc
        self.endpoint = endpoint
        self.metrics_url = metrics_url
        self._port_file = port_file

    @property
    def pid(self):
        return self.proc.pid

    def kill(self):
        """SIGKILL — the chaos path: no drain, no goodbye."""
        self.proc.kill()

    def terminate(self):
        self.proc.terminate()

    def wait(self, timeout=None):
        return self.proc.wait(timeout)

    def cleanup(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(10)
        try:
            os.unlink(self._port_file)
        except OSError:
            pass


def spawn_worker(preset=None, artifacts=None, cache=None, model=None,
                 version=None, fingerprint=None, timeout=180.0,
                 python=None, extra_env=None, device=None, dtype=None):
    """Spawn a ReplicaWorker process and wait for its endpoints.

    Engine bring-up (imports, weights, the device) dominates; `timeout`
    bounds the wait for the port file. Raises RuntimeError if the process
    exits first (its stderr goes to the parent's, so the failure is
    visible in test output). `device` / `dtype` pass on as --device /
    --dtype; the child finds this package whatever its working
    directory (the package's parent leads its PYTHONPATH)."""
    import subprocess
    import tempfile
    fd, port_file = tempfile.mkstemp(prefix='fabric-worker-',
                                     suffix='.json')
    os.close(fd)
    os.unlink(port_file)     # worker writes it atomically when bound
    cmd = [python or sys.executable, '-m',
           'paddle_tpu_torch.serving.fabric.worker',
           '--port-file', port_file]
    if device:
        cmd += ['--device', device]
    if dtype:
        cmd += ['--dtype', dtype]
    if preset:
        cmd += ['--preset', preset]
    if artifacts:
        cmd += ['--artifacts', artifacts, '--cache', cache,
                '--model', model, '--version', version]
        if fingerprint:
            cmd += ['--fingerprint', fingerprint]
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        p for p in (_PACKAGE_PARENT, env.get('PYTHONPATH')) if p)
    env.update(extra_env or {})
    proc = subprocess.Popen(cmd, env=env)
    deadline = time.monotonic() + timeout
    while not os.path.exists(port_file):
        if proc.poll() is not None:
            raise RuntimeError('worker process exited with %r before '
                               'binding' % proc.returncode)
        if time.monotonic() > deadline:
            proc.kill()
            raise RuntimeError('worker did not bind within %.0fs'
                               % timeout)
        time.sleep(0.05)
    with open(port_file) as f:
        info = json.load(f)
    return WorkerHandle(proc, info['endpoint'], info['metrics_url'],
                        port_file)


if __name__ == '__main__':
    sys.exit(main())
