"""The port's serving fabric (paddle_tpu_torch/serving/fabric/) and its
codecs against the JAX package's, on the CPU.

- The PS wire codec and the fabric's JSON frames put the same bytes on
  the wire as the JAX package's, and raise the same typed errors on
  malformed, oversized and mid-frame-dropped frames.
- The prefix directory and the prefix-affinity router give the JAX
  package's depths, LRU and placements on one prompt sequence.
- The port's ReplicaWorker around an echo engine (in process, over real
  loopback sockets): (client, seq) dedup, typed errors, /readyz on drain,
  the socket gateway's parity, failover on a killed worker, rollout
  through socket replicas, and artifacts pulled and verified by
  fingerprint.
- Two spawned `python -m paddle_tpu_torch.serving.fabric.worker --device
  cpu` processes serve the JAX gpt-nano preset's weights, carried across
  and pulled by fingerprint: token parity with the JAX in-process engine,
  also after one is SIGKILLed mid-burst.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import os
import socket
import struct
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu.distributed.ps import wire as jwire
from paddle_tpu.serving.fabric import directory as jdirectory
from paddle_tpu.serving.fabric import protocol as jprotocol
from paddle_tpu_torch.distributed import resilience as tres
from paddle_tpu_torch.distributed.ps import wire as twire
from paddle_tpu_torch.framework import io_save
from paddle_tpu_torch.monitor import events as _events
from paddle_tpu_torch.monitor.registry import MetricRegistry
from paddle_tpu_torch.serving import ServingGateway
from paddle_tpu_torch.serving.fabric import (ArtifactClient, ArtifactServer,
                                             ArtifactVerifyError, MAX_FRAME,
                                             PrefixAffinityRouter,
                                             ReplicaWorker, SocketReplica,
                                             recv_frame, send_frame)
from paddle_tpu_torch.serving.fabric import directory as tdirectory
from paddle_tpu_torch.serving.fabric import protocol as tprotocol
from paddle_tpu_torch.serving.fabric.transport import (DRAINING, READY,
                                                       STOPPED)
from paddle_tpu_torch.serving.registry import ModelHost, ModelRegistry
from paddle_tpu_torch.testing import chaos

MNT = 6


# ---- byte parity of the codecs ----------------------------------------


WIRE_DTYPES = sorted(jwire._ALLOWED_DTYPES)


@pytest.mark.parametrize('dtype', WIRE_DTYPES)
def test_wire_encode_bytes_match_jax(dtype):
    rng = np.random.RandomState(len(dtype))
    arr = (rng.rand(3, 5) * 100).astype(dtype)
    obj = {'op': 'push', 'ids': np.arange(7, dtype=np.int64),
           'rows': arr, 'scalar': np.float32(1.5), 'empty': arr[:0],
           'meta': [None, True, False, -3, 2.25, 'name', b'\x00\x01',
                    (1, 'two')]}
    jb, tb = jwire.encode(obj), twire.encode(obj)
    assert tb == jb
    back = twire.decode(tb)
    assert back['rows'].dtype == arr.dtype
    assert np.array_equal(back['rows'], arr)
    assert back['meta'] == [None, True, False, -3, 2.25, 'name',
                            b'\x00\x01', (1, 'two')]


def test_wire_refusals_match_jax():
    for bad in ({1: 'int key'}, object(), np.zeros(2, np.complex64)):
        with pytest.raises(TypeError):
            jwire.encode(bad)
        with pytest.raises(TypeError):
            twire.encode(bad)
    good = twire.encode({'a': np.ones(4, np.float32)})
    for buf in (good[:-1], good + b'x', b'Z'):
        with pytest.raises(ValueError) as je:
            jwire.decode(buf)
        with pytest.raises(ValueError) as te:
            twire.decode(buf)
        assert str(te.value) == str(je.value)


def _sent_bytes(send, *args, **kw):
    a, b = socket.socketpair()
    try:
        send(a, *args, **kw)
        a.close()
        out = b''
        while True:
            chunk = b.recv(65536)
            if not chunk:
                return out
            out += chunk
    finally:
        b.close()


FRAME_MSGS = [{'op': 'submit', 'client': 'gw-1', 'seq': 3,
               'prompt': [5, 6, 7], 'sampling': {'max_new_tokens': 4,
                                                 'tenant': 'premium'}},
              {'reqs': {'12': 0, '13': 4}, 'ack': ['11']},
              {'op': 'ping', 'text': 'café', 'x': 1.5e-3}]


@pytest.mark.parametrize('msg', FRAME_MSGS, ids=['submit', 'poll', 'ping'])
def test_send_frame_bytes_match_jax(msg):
    jb = _sent_bytes(jprotocol.send_frame, msg)
    tb = _sent_bytes(tprotocol.send_frame, msg)
    assert tb == jb
    # the channel's frame function with the JSON codec and with the PS
    # wire codec (its default) frames the same bytes as the JAX channel's
    from paddle_tpu.distributed import resilience as jres
    for codec in (tprotocol.JSON_CODEC, None):
        jcodec = None if codec is None else jprotocol.JSON_CODEC
        assert _sent_bytes(tres._send_frame, msg, codec) == \
            _sent_bytes(jres._send_frame, msg, jcodec)


def _recv_error(proto, raw, close=True, **kw):
    a, b = socket.socketpair()
    try:
        a.sendall(raw)
        if close:
            a.close()
        try:
            return proto.recv_frame(b, **kw)
        except Exception as e:     # noqa: BLE001 — the type is the result
            return type(e).__name__
    finally:
        b.close()
        if not close:
            a.close()


BAD_FRAMES = {
    'malformed': struct.pack('>Q', 17) + b'\xff\xfenot json at all',
    'oversized': struct.pack('>Q', MAX_FRAME + 1),
    'mid_frame': struct.pack('>Q', 100) + b'only ten b',
    'mid_header': b'\x00\x00\x00',
    'clean_eof': b'',
}


@pytest.mark.parametrize('case', sorted(BAD_FRAMES))
def test_frame_errors_are_typed_as_in_jax(case):
    raw = BAD_FRAMES[case]
    # the oversized header is refused before its body is awaited
    close = case != 'oversized'
    got = _recv_error(tprotocol, raw, close=close)
    assert got == _recv_error(jprotocol, raw, close=close)
    assert got == {'malformed': 'FrameDecodeError',
                   'oversized': 'FrameTooLargeError',
                   'mid_frame': 'ConnectionError',
                   'mid_header': 'ConnectionError',
                   'clean_eof': None}[case]


def test_send_side_refusals_are_typed():
    a, b = socket.socketpair()
    try:
        with pytest.raises(tprotocol.FrameDecodeError):
            send_frame(a, {'op': object()})
        with pytest.raises(tprotocol.FrameTooLargeError):
            send_frame(a, {'blob': 'x' * 64}, max_frame=16)
        send_frame(a, {'op': 'ping', 'n': [1, 2, 3]})
        assert recv_frame(b) == {'op': 'ping', 'n': [1, 2, 3]}
    finally:
        a.close()
        b.close()


# ---- prefix directory and affinity routing against the JAX package ------


def _prompt_sequence():
    rng = np.random.RandomState(3)
    shared = [int(t) for t in rng.randint(0, 50, 16)]
    other = [int(t) for t in rng.randint(50, 99, 12)]
    seq = [shared + [100], shared + [101, 102], other + [7], shared[:5],
           [1, 2, 3, 4], other + [8, 9, 10, 11, 12], shared + other]
    seq += [[60 + i] * 5 for i in range(10)]
    seq += [shared + [200], other + [1]]
    return seq


def test_prefix_directory_depths_and_lru_match_jax():
    jd = jdirectory.PrefixDirectory(page_size=4, capacity=8)
    td = tdirectory.PrefixDirectory(page_size=4, capacity=8)
    for i, prompt in enumerate(_prompt_sequence()):
        assert td.depths(prompt) == jd.depths(prompt), i
        assert td.chain_hashes(prompt) == jd.chain_hashes(prompt), i
        td.observe(prompt, i % 3)
        jd.observe(prompt, i % 3)
        assert len(td) == len(jd) <= 8
        assert list(td._dir.items()) == list(jd._dir.items()), i


class _Rep:
    def __init__(self, index, load):
        self.index = index
        self._load = load

    def routable(self):
        return True

    def load(self):
        return self._load


class _Gw:
    def __init__(self, prompt):
        self.prompt = prompt


def test_prefix_affinity_router_placements_match_jax():
    routers = (jdirectory.PrefixAffinityRouter(page_size=4),
               tdirectory.PrefixAffinityRouter(page_size=4))
    pools = [[_Rep(0, 0.0), _Rep(1, 5.0), _Rep(2, 1.0)] for _ in routers]
    placed = ([], [])
    for i, prompt in enumerate(_prompt_sequence()):
        for k, (r, pool) in enumerate(zip(routers, pools)):
            order = [x.index for x in r.candidates_for_request(pool,
                                                               _Gw(prompt))]
            placed[k].append(order)
            r.note_placement(prompt, order[0])
            pool[order[0]]._load += 1.0      # the placement loads it
    assert placed[1] == placed[0]
    # a prompt sharing a placed prefix follows it, despite the load
    assert len({tuple(o) for o in placed[1]}) > 1


# ---- the worker over loopback sockets ----------------------------------


class _StubReq:
    def __init__(self, rid, prompt, max_new_tokens):
        self.id = rid
        self.prompt = list(prompt)
        self.tokens = []
        self.done = False
        self.outcome = None
        self.max_new = int(max_new_tokens)
        self._admit_t = time.monotonic()
        self._arrival_t = self._admit_t
        self._prefill_chunks = 1
        self._prefix_hit = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self.kv_page_seconds = 0.0


def _expected(prompt, n):
    """The echo engine's output: a pure function of the prompt, so a
    failover to a fresh engine reproduces it exactly."""
    return [(prompt[-1] + i + 1) % 997 for i in range(n)]


class EchoEngine:
    """Engine-contract stub: each step() appends one deterministic token
    per in-flight request."""

    num_slots = 4

    class _Sched:
        def __init__(self, eng):
            self._eng = eng

        @property
        def queue(self):
            return [r for r in self._eng._reqs if not r.done]

        @property
        def pending(self):
            return len(self.queue)

    def __init__(self, step_delay=0.0005):
        self.scheduler = EchoEngine._Sched(self)
        self._reqs = []
        self._lock = threading.Lock()
        self._ids = 0
        self._down = False
        self.submits = 0
        self._delay = step_delay

    def add_request(self, prompt, max_new_tokens=MNT, emit_event=True,
                    **kw):
        with self._lock:
            if self._down:
                raise RuntimeError('engine is shut down')
            if not prompt:
                raise ValueError('empty prompt')
            self._ids += 1
            self.submits += 1
            r = _StubReq(self._ids, prompt, max_new_tokens)
            self._reqs.append(r)
            return r

    def step(self):
        with self._lock:
            for r in self._reqs:
                if r.done:
                    continue
                r.tokens.append(_expected(r.prompt, r.max_new)
                                [len(r.tokens)])
                if len(r.tokens) >= r.max_new:
                    r.done = True
                    r.outcome = 'ok'
            self._reqs = [r for r in self._reqs if not r.done]
        if self._delay:
            time.sleep(self._delay)
        return 1

    def shutdown(self):
        with self._lock:
            self._down = True


def _stop_all(workers):
    for w in workers:
        try:
            w.stop()
        except Exception:    # noqa: BLE001 — already killed
            pass


@pytest.fixture
def worker():
    w = ReplicaWorker(EchoEngine()).start()
    yield w
    _stop_all([w])


@pytest.fixture
def worker_pair():
    ws = [ReplicaWorker(EchoEngine()).start() for _ in range(2)]
    yield ws
    _stop_all(ws)


def _raw_conn(worker):
    host, port = worker.endpoint.rsplit(':', 1)
    return socket.create_connection((host, int(port)), timeout=5)


def _fabric_gateway(workers, **kw):
    kw.setdefault('registry', MetricRegistry())
    gw = ServingGateway(None, replicas=0, **kw)
    for w in workers:
        gw.adopt_replica(
            SocketReplica(w.endpoint, metrics_url=w.metrics_url,
                          poll_interval=0.001).connect())
    return gw


def _counter(gw, name, labels=None):
    fam = gw.registry.get(name)
    return fam.value() if labels is None else fam.labels(*labels).value()


@pytest.mark.parametrize('case', ['malformed', 'oversized', 'mid_frame'])
def test_worker_survives_bad_frames_with_typed_replies(worker, case):
    s = _raw_conn(worker)
    try:
        if case == 'malformed':
            s.sendall(struct.pack('>Q', 7) + b'{broken')
            assert recv_frame(s)['error_type'] == 'FrameDecodeError'
        elif case == 'oversized':
            s.sendall(struct.pack('>Q', MAX_FRAME + 1))
            assert recv_frame(s)['error_type'] == 'FrameTooLargeError'
        else:
            s.sendall(struct.pack('>Q', 5000) + b'partial')
    finally:
        s.close()
    # the worker is not hung: a fresh connection still serves
    s = _raw_conn(worker)
    try:
        send_frame(s, {'op': 'status'})
        out = recv_frame(s)
        assert out['ok'] is True and out['state'] == READY
        assert out['multi_model'] is False
    finally:
        s.close()


def test_duplicate_submit_dedups_on_client_seq(worker):
    msg = {'op': 'submit', 'client': 'c1', 'seq': 1, 'prompt': [5],
           'sampling': {'max_new_tokens': 2}}
    s = _raw_conn(worker)
    try:
        send_frame(s, msg)
        r1 = recv_frame(s)
        assert not r1.get('dup')
        send_frame(s, msg)              # a retried send: same req_id
        r2 = recv_frame(s)
        assert r2['req_id'] == r1['req_id'] and r2['dup'] is True
        assert worker.engine.submits == 1
        send_frame(s, dict(msg, seq=0))  # a stale seq is typed
        assert recv_frame(s)['error_type'] == 'ValueError'
        # polls at explicit offsets; a retried poll of a finished request
        # answers the same until it is acked
        deadline = time.monotonic() + 5
        while True:
            send_frame(s, {'op': 'poll', 'reqs': {r1['req_id']: 0},
                           'ack': []})
            rec = recv_frame(s)['reqs'][r1['req_id']]
            if rec['done'] or time.monotonic() > deadline:
                break
            time.sleep(0.005)
        assert rec['done'] and rec['tokens'] == _expected([5], 2)
        assert rec['outcome'] == 'ok'
        send_frame(s, {'op': 'poll', 'reqs': {r1['req_id']: 1}, 'ack': []})
        again = recv_frame(s)['reqs'][r1['req_id']]
        assert again['tokens'] == _expected([5], 2)[1:]
    finally:
        s.close()


def test_poll_unknown_request_is_typed_not_hung(worker):
    s = _raw_conn(worker)
    try:
        send_frame(s, {'op': 'poll', 'reqs': {'999': 0}, 'ack': []})
        out = recv_frame(s)
        assert out['reqs']['999']['unknown'] is True
        assert out['reqs']['999']['outcome'] == 'error'
        send_frame(s, {'op': 'frobnicate'})
        assert recv_frame(s)['error_type'] == 'ValueError'
        send_frame(s, {'op': 'rollout_prepare', 'model': 'm',
                       'version': 'v2'})
        assert recv_frame(s)['error_type'] == 'RuntimeError'   # no host
    finally:
        s.close()


def test_worker_readyz_flips_503_on_drain_healthz_stays(worker):
    def code(route):
        try:
            with urllib.request.urlopen(worker.metrics_url + route,
                                        timeout=5) as resp:
                return resp.status
        except urllib.error.HTTPError as e:
            return e.code
    assert (code('/readyz'), code('/healthz')) == (200, 200)
    s = _raw_conn(worker)
    try:
        send_frame(s, {'op': 'drain'})
        assert recv_frame(s)['state'] == DRAINING
    finally:
        s.close()
    assert (code('/readyz'), code('/healthz')) == (503, 200)
    deadline = time.monotonic() + 5
    while worker.state != STOPPED and time.monotonic() < deadline:
        time.sleep(0.01)
    assert worker.state == STOPPED
    s = _raw_conn(worker)
    try:
        send_frame(s, {'op': 'submit', 'prompt': [1], 'sampling': {}})
        assert recv_frame(s)['error_type'] == 'RuntimeError'
    finally:
        s.close()


def test_socket_gateway_parity_and_one_wide_event_per_request(
        worker_pair):
    log = _events.RequestLog()
    prev = _events.set_default_request_log(log)
    try:
        gw = _fabric_gateway(worker_pair)
        prompts = [[3 + i, 7 + i] for i in range(8)]
        out = gw.generate(prompts, max_new_tokens=MNT)
        gw.shutdown()
    finally:
        _events.set_default_request_log(prev)
    assert out == [_expected(p, MNT) for p in prompts]
    routed = [_counter(gw, 'gateway_route_total', (str(i),))
              for i in range(2)]
    assert sum(routed) == len(prompts) and all(routed), routed
    evs = log.events()
    assert len(evs) == len(prompts)
    assert all(len(e['replicas']) == 1 and e['outcome'] == 'ok'
               for e in evs)


def test_socket_gateway_failover_on_killed_worker():
    """chaos.kill_server on one worker mid-burst: every request completes
    with the no-fault tokens, and the failovers are the victim's
    in-flight requests."""
    workers = [ReplicaWorker(EchoEngine(step_delay=0.01)).start()
               for _ in range(2)]
    log = _events.RequestLog()
    prev = _events.set_default_request_log(log)
    try:
        gw = _fabric_gateway(workers)
        gw.start()
        prompts = [[11 + i] for i in range(10)]
        reqs = [gw.submit(p, max_new_tokens=24) for p in prompts]
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            with gw._lock:
                if all(len(r.assigned) > 0 for r in gw.pool):
                    break
            time.sleep(0.002)
        n_victim = len(gw.pool[0].assigned)
        assert n_victim > 0
        with workers[0]._lock:      # the drive stops with the server
            workers[0]._stopping = True
        chaos.kill_server(workers[0])
        for r in reqs:
            assert r.wait(timeout=30), 'request %d never finished' % r.id
        gw.shutdown()
    finally:
        _events.set_default_request_log(prev)
        _stop_all(workers)
    assert [r.tokens for r in reqs] == [_expected(p, 24) for p in prompts]
    fo = _counter(gw, 'gateway_failover_total')
    assert 1 <= fo <= n_victim
    evs = log.events()
    assert len(evs) == len(prompts)
    failed_over = [e for e in evs if len(e['replicas']) == 2]
    assert len(failed_over) == fo
    assert all(e['replicas'] == [0, 1] for e in failed_over)


def test_socket_gateway_inadmissible_raises_not_failover(worker_pair):
    gw = _fabric_gateway(worker_pair)
    with pytest.raises(ValueError):
        gw.submit([], max_new_tokens=2)     # the echo engine refuses it
    assert _counter(gw, 'gateway_failover_total') == 0
    assert gw.replicas_alive == 2
    gw.shutdown()


def test_prefix_affinity_gateway_keeps_shared_prefix_together(
        worker_pair):
    gw = _fabric_gateway(worker_pair,
                         router=PrefixAffinityRouter(page_size=4))
    shared = [7] * 16
    first = gw.submit(shared + [1], max_new_tokens=2)
    gw.run()
    warm = first.replica_history[0]
    rest = [gw.submit(shared + [2 + i], max_new_tokens=2)
            for i in range(5)]
    gw.run()
    gw.shutdown()
    assert all(r.replica_history == [warm] for r in rest)
    assert _counter(gw, 'gateway_route_total', (str(warm),)) == 6.0


# ---- rollout and artifacts through the fabric --------------------------


class _HostStubEngine:
    """Emits the serving VERSION's digit, so a test can tell which
    weights answered."""

    max_len = 128
    num_slots = 4

    def __init__(self, entry):
        from paddle_tpu_torch.serving.metrics import ServingMetrics
        self.entry = entry
        self.metrics = ServingMetrics(registry=MetricRegistry())
        self._reqs = []

    class _Sched:
        def __init__(self, eng):
            self._eng = eng

        @property
        def pending(self):
            return sum(1 for r in self._eng._reqs if not r.done)

        @property
        def queue(self):
            return tuple(r for r in self._eng._reqs if not r.done)

    @property
    def scheduler(self):
        return _HostStubEngine._Sched(self)

    def enqueue(self, req):
        if req._arrival_t is None:
            req._arrival_t = self.metrics.now()
        self._reqs.append(req)
        return req

    def step(self):
        from paddle_tpu_torch.serving.scheduler import DONE
        for r in self._reqs:
            if not r.done:
                r.tokens.extend([int(self.entry.version[-1])]
                                * r.max_new_tokens)
                r.state = DONE
                r.outcome = 'ok'
                r._finished.set()
        return self.scheduler.pending

    def generate(self, prompts, max_new_tokens=2, emit_event=True):
        return [[1] * max_new_tokens for _ in prompts]

    def shutdown(self):
        pass

    def rebind_perf(self, registry):
        pass


def _publish_zoo(root):
    reg = ModelRegistry(root=str(root))
    reg.publish('alpha', 'v1', {'w': np.full(64, 1.0, np.float32)})
    reg.publish('alpha', 'v2', {'w': np.full(64, 2.0, np.float32)})
    return reg


def _host_worker(registry, client=None):
    host = ModelHost(registry, _HostStubEngine)
    return ReplicaWorker(host, artifact_client=client).start()


def test_rollout_through_socket_replicas_zero_loss(tmp_path):
    ws = [_host_worker(_publish_zoo(tmp_path / ('w%d' % i)))
          for i in range(2)]
    try:
        gw = _fabric_gateway(ws)
        before = [gw.submit([1, 2], max_new_tokens=4, model='alpha')
                  for _ in range(6)]
        gw.run()
        summary = gw.rollout('alpha', 'v2')
        after = [gw.submit([3], max_new_tokens=4, model='alpha')
                 for _ in range(4)]
        gw.run()
        gw.shutdown()
    finally:
        _stop_all(ws)
    assert all(r.done and r.error is None for r in before + after)
    assert (summary['model'], summary['from_version'],
            summary['to_version'], summary['replicas']) == \
        ('alpha', 'v1', 'v2', [0, 1])
    # the stubs build no kernel: the warm bring-ups compiled nothing
    assert (summary['cache_hits'], summary['cache_misses']) == (0, 0)
    assert all(r.tokens == [1] * 4 for r in before)
    assert all(r.tokens == [2] * 4 for r in after)
    for w in ws:
        assert w.engine.registry.serving_version('alpha') == 'v2'


def test_rollout_pulls_missing_artifact_over_fabric(tmp_path):
    src = _publish_zoo(tmp_path / 'src')
    art = ArtifactServer(src).start()
    local = ModelRegistry(root=str(tmp_path / 'w0'))
    local.publish('alpha', 'v1', {'w': np.full(64, 1.0, np.float32)})
    client = ArtifactClient(art.endpoint, str(tmp_path / 'cache'))
    w = _host_worker(local, client)
    try:
        gw = _fabric_gateway([w])
        r = gw.submit([1], max_new_tokens=2, model='alpha')
        gw.run()
        assert r.tokens == [1, 1]
        assert ('alpha', 'v2') not in local
        assert gw.rollout('alpha', 'v2')['to_version'] == 'v2'
        assert local.entry('alpha', 'v2').fingerprint == \
            src.entry('alpha', 'v2').fingerprint
        r2 = gw.submit([1], max_new_tokens=2, model='alpha')
        gw.run()
        assert r2.tokens == [2, 2]
        gw.shutdown()
    finally:
        w.stop()
        art.stop()


def _corrupt(path, at=-3):
    with open(path, 'rb') as f:
        blob = bytearray(f.read())
    blob[at] ^= 0xFF
    with open(path, 'wb') as f:
        f.write(bytes(blob))


@pytest.mark.parametrize('fault', ['none', 'payload', 'manifest'])
def test_artifact_pull_verifies_what_it_pulls(tmp_path, fault):
    src = _publish_zoo(tmp_path / 'src')
    path = src.entry('alpha', 'v1').path
    if fault == 'payload':
        _corrupt(path)                 # CRC check at register() catches it
    elif fault == 'manifest':
        _corrupt(io_save.manifest_path(path))    # fingerprint mismatch
    art = ArtifactServer(src).start()
    try:
        dst = ModelRegistry(root=str(tmp_path / 'dst'))
        client = ArtifactClient(art.endpoint, str(tmp_path / 'cache'))
        if fault == 'none':
            entry = client.ensure(dst, 'alpha', 'v1')
            assert entry.fingerprint == src.entry('alpha', 'v1').fingerprint
            assert client.ensure(dst, 'alpha', 'v1').path == entry.path
            back = io_save.load(entry.path)
            assert np.array_equal(back['w'], np.full(64, 1.0, np.float32))
        else:
            with pytest.raises(ArtifactVerifyError):
                client.ensure(dst, 'alpha', 'v1')
            assert ('alpha', 'v1') not in dst
        client.close()
    finally:
        art.stop()


def test_artifact_fetch_refuses_path_traversal(tmp_path):
    src = _publish_zoo(tmp_path / 'src')
    art = ArtifactServer(src).start()
    try:
        s = socket.create_connection(('127.0.0.1', art.port), timeout=5)
        try:
            for name in ('../../etc/passwd', '/etc/passwd', 'a/../b'):
                send_frame(s, {'op': 'fetch', 'model': 'alpha',
                               'version': 'v1', 'file': name, 'offset': 0})
                out = recv_frame(s)
                assert 'bad artifact file name' in out['error'], out
        finally:
            s.close()
    finally:
        art.stop()


# ---- presets and the worker's device ------------------------------------


def test_presets_build_deterministic_models(tmp_path):
    import torch
    from paddle_tpu.serving.fabric import presets as jpresets
    from paddle_tpu_torch.serving.fabric import presets as tpresets
    # the JAX zoo verbatim, plus the full-width row the card runs use
    for name, spec in jpresets.PRESETS.items():
        assert tpresets.PRESETS[name] == spec, name
    assert set(tpresets.PRESETS) - set(jpresets.PRESETS) == {'gpt-bench'}
    with pytest.raises(KeyError):
        tpresets.preset('gpt-colossal')
    sd1 = tpresets.build_model('gpt-nano', device='cpu').state_dict()
    sd2 = tpresets.build_model('gpt-nano', device='cpu').state_dict()
    assert all(torch.equal(sd1[k], sd2[k]) for k in sd1)
    eng = tpresets.build_engine('gpt-nano', device='cpu')
    ref = eng.generate([[5, 6, 7]], max_new_tokens=4)
    reg = ModelRegistry(root=str(tmp_path))
    entry = tpresets.publish_preset(reg, 'gpt-nano', device='cpu')
    assert entry.meta['preset'] == 'gpt-nano'
    eng2 = tpresets.host_factory(device='cpu')(reg.entry('gpt-nano', 'v0'))
    assert eng2.generate([[5, 6, 7]], max_new_tokens=4) == ref
    bf16 = tpresets.build_model('gpt-nano', device='cpu', dtype='bfloat16')
    assert bf16.gpt.wte.weight.dtype == torch.bfloat16


def test_preset_variant_published_with_model_overrides(tmp_path):
    """A preset published with GPTConfig overrides (one layer of
    gpt-nano's two) carries them in its meta; host_factory rebuilds that
    architecture around the artifact and serves its tokens."""
    from paddle_tpu_torch.serving.fabric import presets as tpresets
    cut = tpresets.build_model('gpt-nano', device='cpu',
                               model={'num_layers': 1})
    assert cut.config.num_layers == len(cut.gpt.h) == 1
    ref = tpresets.build_engine('gpt-nano', model=cut).generate(
        [[5, 6, 7]], max_new_tokens=4)
    reg = ModelRegistry(root=str(tmp_path))
    entry = tpresets.publish_preset(reg, 'gpt-nano', device='cpu',
                                    model={'num_layers': 1})
    assert entry.meta == {'preset': 'gpt-nano', 'model': {'num_layers': 1}}
    eng = tpresets.host_factory(device='cpu')(reg.entry('gpt-nano', 'v0'))
    assert len(eng._model.gpt.h) == 1
    assert eng.generate([[5, 6, 7]], max_new_tokens=4) == ref


def test_worker_defaults_to_the_card_and_raises_without_one(
        tmp_path, monkeypatch):
    import torch
    from paddle_tpu_torch.serving.fabric import worker as fworker
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    port_file = str(tmp_path / 'w.json')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        fworker.main(['--preset', 'gpt-nano', '--port-file', port_file])
    assert not os.path.exists(port_file)


# ---- real worker processes on the JAX preset's weights -------------------


def test_spawned_workers_serve_jax_weights_with_failover(tmp_path):
    """Two `python -m paddle_tpu_torch.serving.fabric.worker --device cpu`
    processes pull the JAX gpt-nano weights (carried into the port and
    published) by fingerprint; a gateway over them matches the JAX
    in-process engine's tokens, and still does after one is SIGKILLed
    mid-burst."""
    from paddle_tpu.serving.fabric import presets as jpresets
    from paddle_tpu_torch.serving.fabric import presets as tpresets
    from paddle_tpu_torch.serving.fabric import spawn_worker
    from paddle_tpu_torch.text.models.gpt import load_paddle_tpu_state

    jmodel = jpresets.build_model('gpt-nano')
    rng = np.random.RandomState(11)
    prompts = [[int(t) for t in rng.randint(0, 211, n)]
               for n in (3, 9, 5, 12, 4, 7, 6, 10)]
    new = 8
    jeng = jpresets.build_engine('gpt-nano', model=jmodel)
    reference = jeng.generate(prompts, max_new_tokens=new)
    jeng.shutdown()

    tmodel = tpresets.build_model('gpt-nano', device='cpu')
    load_paddle_tpu_state(tmodel, {k: np.asarray(v.numpy()) for k, v in
                                   jmodel.state_dict().items()})
    reg = ModelRegistry(root=str(tmp_path / 'src'))
    entry = reg.publish('gpt-nano', 'v0', tmodel.state_dict(),
                        meta={'preset': 'gpt-nano'})
    art = ArtifactServer(reg).start()
    handles = []
    env = {'OMP_NUM_THREADS': '1', 'MKL_NUM_THREADS': '1'}
    try:
        for i in range(2):
            handles.append(spawn_worker(
                artifacts=art.endpoint, cache=str(tmp_path / ('w%d' % i)),
                model='gpt-nano', version='v0',
                fingerprint=entry.fingerprint, device='cpu', timeout=60,
                extra_env=env))
        gw = ServingGateway(None, replicas=0, registry=MetricRegistry())
        for h in handles:
            gw.adopt_replica(SocketReplica(h.endpoint,
                                           metrics_url=h.metrics_url,
                                           poll_interval=0.002).connect())
        assert gw.generate(prompts[:2], max_new_tokens=new) == reference[:2]
        gw.start()
        reqs = []
        for i, p in enumerate(prompts):
            reqs.append(gw.submit(p, max_new_tokens=new))
            if i == len(prompts) // 2:
                handles[0].kill()           # SIGKILL, no goodbye
        for r in reqs:
            assert r.wait(timeout=60), 'request %d never completed' % r.id
        gw.shutdown()
        failovers = _counter(gw, 'gateway_failover_total')
    finally:
        for h in handles:
            h.cleanup()
        art.stop()
    assert all(r.done and r.error is None for r in reqs)
    assert [r.tokens for r in reqs] == reference
    crossed = [r for r in reqs if len(r.replica_history) > 1]
    assert len(crossed) == failovers
    assert all(r.replica_history[-1] == 1 for r in crossed)
