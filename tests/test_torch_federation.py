"""The port's fleet telemetry plane (paddle_tpu_torch/monitor/federation.py,
alerts.py, the /fleet /alerts /requests routes and the gateway's fleet
hooks) against the JAX package's, on the CPU, all exact: merge_snapshots
of the same snapshots; a FleetCollector over in-process registries plus
one port MetricsServer URL against the JAX merge; the AlertManager's
state walk and dump count over one snapshot sequence on a fake clock;
tools/fleet_status.py on the port's fleet line and alert body; the sync
gateway with the fleet attached and a federated burn source making the
JAX gateway's decisions.
"""
import glob
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.monitor import alerts as jalerts
from paddle_tpu.monitor import export as jexport
from paddle_tpu.monitor import federation as jfed
from paddle_tpu.monitor import tracing as jtracing
from paddle_tpu.monitor.registry import MetricRegistry as JRegistry
from paddle_tpu.serving import ContinuousBatchingEngine as JSlotEngine
from paddle_tpu.serving import ServingGateway as JGateway
from paddle_tpu.serving.gateway import AutoscalePolicy as JPolicy
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu.text.models import gpt as jgpt
from paddle_tpu_torch.monitor import alerts as talerts
from paddle_tpu_torch.monitor import events as tevents
from paddle_tpu_torch.monitor import export as texport
from paddle_tpu_torch.monitor import federation as tfed
from paddle_tpu_torch.monitor import tracing as ttracing
from paddle_tpu_torch.monitor.registry import MetricRegistry
from paddle_tpu_torch.monitor.server import MetricsServer
from paddle_tpu_torch.serving import ContinuousBatchingEngine, ServingGateway
from paddle_tpu_torch.serving.gateway import AutoscalePolicy
from paddle_tpu_torch.testing import chaos
from paddle_tpu_torch.text.models import gpt as tgpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = (JRegistry, jfed, jalerts, jtracing, jexport)
PORT = (MetricRegistry, tfed, talerts, ttracing, texport)


def _fill(reg_cls, counter=0.0, gauge=None, hist=(), tenant=None):
    """A registry with one family of each kind (fixed shared names)."""
    r = reg_cls()
    c = r.counter('fed_tokens_total', 'tokens', ('tenant',))
    c.labels(tenant or 'a').inc(counter)
    if gauge is not None:
        r.gauge('fed_occupancy', 'occ').set(gauge)
    h = r.histogram('fed_lat_seconds', 'lat', buckets=(0.1, 1.0, 10.0))
    for v in hist:
        h.observe(v)
    return r


SNAPS = [('r0', dict(counter=3, gauge=0.5, hist=(0.05, 2.0))),
         ('r1', dict(counter=4, gauge=0.25, hist=(0.5,), tenant='b')),
         ('r2', dict(counter=1, hist=(20.0, 0.2)))]


def test_merge_snapshots_equal_jax():
    """Counters summed per label set, gauges per instance, histograms
    bucket-wise, a conflicting family dropped and reported: equal
    dicts."""
    out = []
    for reg_cls, fed, _, _, exp in (JAX, PORT):
        named = [(n, exp.to_dict(_fill(reg_cls, **kw))) for n, kw in SNAPS]
        bad = reg_cls()
        bad.gauge('fed_tokens_total', 'now a gauge')
        named.append(('r3', exp.to_dict(bad)))
        conflicts = []
        out.append((fed.merge_snapshots(named, conflicts=conflicts),
                    conflicts))
    assert out[1] == out[0]
    assert out[1][1] and 'fed_lat_seconds' in out[1][0]


def test_collector_inproc_and_port_http_target_equal_jax():
    """A FleetCollector over two in-process registries and one port
    MetricsServer URL (the same third registry behind the JAX side's
    in-process target) merges to the JAX collector's merged view; a dead
    URL target stays stale, its totals held."""
    served = _fill(MetricRegistry, counter=5, gauge=0.75, hist=(0.3,))
    srv = MetricsServer(registry=served).start()
    try:
        runs = []
        for reg_cls, fed, _, _, exp in (JAX, PORT):
            fc = fed.FleetCollector(registry=reg_cls(), clock=lambda: 5.0)
            for n, kw in SNAPS[:2]:
                fc.add_target(n, registry=_fill(reg_cls, **kw))
            if fed is tfed:
                fc.add_target('http', url=srv.url)
            else:
                fc.add_target('http', registry=_fill(
                    reg_cls, counter=5, gauge=0.75, hist=(0.3,)))
            assert fc.scrape() == {'ok': 3, 'down': 0}
            runs.append((fc, fc.merged(), fc.fleet_status()['up']))
        assert runs[1][1] == runs[0][1] and runs[1][2] == runs[0][2] == 3
        fc, before, _ = runs[1]
    finally:
        srv.stop()
    assert fc.scrape() == {'ok': 2, 'down': 1}
    status = fc.fleet_status()['targets']['http']
    assert status['up'] is False and status['stale'] is True
    assert fc.merged()['fed_tokens_total'] == before['fed_tokens_total']


def _alert_walk(pkg, tmp):
    """One snapshot sequence through an AlertManager on a fake clock:
    (edges per tick, final state, dump files, alert metric samples)."""
    reg_cls, _, al, tr, exp = pkg
    reg = reg_cls()
    g = reg.gauge('occ', 'occupancy')
    h = reg.histogram('lat', 'latency', buckets=(0.1, 0.5, 1.0))
    rec = tr.FlightRecorder(dump_dir=tmp, registry=reg_cls())
    mgr = al.AlertManager(
        [al.ThresholdRule('hot', 'occ', 0.8, op='>', for_duration=10.0,
                          resolve_after=5.0),
         al.BurnRateRule('burn', 'lat', 0.5, objective=0.9,
                         windows=((20.0, 5.0, 2.0),))],
        source=lambda: exp.to_dict(reg), registry=reg, recorder=rec,
        clock=lambda: 0.0)
    walk = []
    plan = [(0.0, 0.1, ()), (1.0, 0.9, (0.05,) * 4), (10.9, 0.9, (0.7,)),
            (11.0, 0.9, (0.7,) * 3), (12.0, 0.9, ()), (13.0, 0.1, ()),
            (14.0, 0.9, (0.05,)), (20.0, 0.1, ()), (25.0, 0.1, ()),
            (30.0, 0.9, (0.9,) * 5), (40.0, 0.9, ()), (60.0, 0.1, ())]
    for t, occ, obs in plan:
        g.set(occ)
        for v in obs:
            h.observe(v)
        walk.append(mgr.evaluate(now=t))
    state = mgr.state()
    dumps = sorted(os.path.basename(p) for p in
                   glob.glob(os.path.join(tmp, 'flight_alert_firing_*')))
    fams = exp.to_dict(reg)
    return walk, state, dumps, {n: fams[n] for n in fams
                                if n.startswith('alerts_')}


def test_alert_manager_walk_equal_jax(tmp_path):
    """Pending, firing (one flight dump an edge), hysteresis, resolve and
    re-fire of a threshold rule beside a burn-rate rule: the same edges
    at the same ticks, the same /alerts state, dumps and alert metrics."""
    jax = _alert_walk(JAX, str(tmp_path / 'jax'))
    port = _alert_walk(PORT, str(tmp_path / 'port'))
    assert port == jax
    assert ['hot', 'firing'] in [list(e) for es in port[0] for e in es]
    assert len(port[2]) >= 2


def test_federated_burn_source_equal_jax():
    """federated_burn_source over a collector of two registries whose
    histogram grows between fake-clock reads: equal burn fractions."""
    out = []
    for reg_cls, fed, al, _, _ in (JAX, PORT):
        regs = [reg_cls(), reg_cls()]
        hs = [r.histogram('gateway_ttft_seconds', 'ttft',
                          buckets=(0.1, 0.2, 0.4)) for r in regs]
        fc = fed.FleetCollector(registry=reg_cls(), clock=lambda: 0.0)
        for i, r in enumerate(regs):
            fc.add_target('g%d' % i, registry=r)
        burn = al.federated_burn_source(fc, 0.2, window_s=10.0)
        seq = []
        for t, vals in ((0.0, (0.05, 0.3)), (5.0, (0.5, 0.5, 0.1)),
                        (12.0, (0.1,)), (30.0, ())):
            for i, v in enumerate(vals):
                hs[i % 2].observe(v)
            fc.scrape()
            seq.append(burn(t))
        out.append(seq)
    assert out[1] == out[0] and max(out[1]) > 0


def test_fleet_status_tool_reads_port_artifacts(tmp_path):
    """tools/fleet_status.py accepts the port's fleet_snapshot line, its
    /alerts body and a directory of its flight dumps."""
    fc = tfed.FleetCollector(registry=MetricRegistry(), clock=lambda: 1.0)
    fc.add_target('a', registry=_fill(MetricRegistry, counter=6,
                                      hist=(0.5,)))
    fc.scrape()
    line = tfed.fleet_snapshot_line(fc, 8, '[dp/mp]')
    m = tfed.FLEET_LINE_RE.search(line)
    assert m and m.group('tag') == 'dp/mp'
    (tmp_path / 'fleet.txt').write_text('noise\n' + line + '\n')
    reg = MetricRegistry()
    reg.gauge('occ', 'o').set(1.0)
    rec = ttracing.FlightRecorder(dump_dir=str(tmp_path / 'flight'),
                                  registry=reg)
    rec.record({'name': 'x', 'trace_id': 't', 'span_id': 's', 'start': 1.0,
                'end': 2.0})
    mgr = talerts.AlertManager([talerts.ThresholdRule('hot', 'occ', 0.5)],
                               source=lambda: texport.to_dict(reg),
                               registry=reg, recorder=rec)
    mgr.evaluate(now=1.0)
    (tmp_path / 'alerts.json').write_text(json.dumps(
        {'firing': mgr.firing(), 'alerts': mgr.state()}))
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, 'tools', 'fleet_status.py'),
         '--fleet', str(tmp_path / 'fleet.txt'),
         '--alerts', str(tmp_path / 'alerts.json'),
         '--flight', 'port=%s' % (tmp_path / 'flight'),
         '--chrome-out', str(tmp_path / 'chrome.json')],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert 'hot' in out.stdout and 'a' in out.stdout
    assert json.load(open(tmp_path / 'chrome.json'))['traceEvents']


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read().decode())


def test_server_fleet_alerts_requests_routes(tmp_path):
    """/fleet (?scrape=1, ?format=prom), /alerts (?evaluate=1) and
    /requests (filters) on the port's MetricsServer; an unattached route
    answers 404, a bad filter 400."""
    reg = MetricRegistry()
    fc = tfed.FleetCollector(registry=reg, clock=lambda: 1.0)
    fc.add_target('a', registry=_fill(MetricRegistry, counter=11,
                                      hist=(0.05,)))
    mgr = talerts.AlertManager(
        [talerts.ThresholdRule('many', 'fed_tokens_total', 10.0)],
        source=fc.merged, registry=reg,
        recorder=ttracing.FlightRecorder(registry=reg))
    log = tevents.RequestLog(registry=reg)
    for i in range(4):
        log.emit(request_id=i, tenant='t%d' % (i % 2), outcome='ok',
                 failovers=i % 3, arrival_t=float(i))
    with MetricsServer(registry=reg, collector=fc, alerts=mgr,
                       events=log) as srv:
        fleet = _get(srv.url + '/fleet?scrape=1')
        assert fleet['up'] == 1 and fleet['targets']['a']['up'] is True
        assert fleet['merged']['fed_tokens_total']['samples'][0][
            'value'] == 11.0
        with urllib.request.urlopen(srv.url + '/fleet?format=prom') as r:
            assert b'fed_tokens_total' in r.read()
        al = _get(srv.url + '/alerts?evaluate=1')
        assert al['firing'] == ['many']
        assert al['alerts'][0]['rule']['name'] == 'many'
        rq = _get(srv.url + '/requests?tenant=t1')
        assert rq['count'] == 2 and [e['request_id'] for e in
                                     rq['events']] == [1, 3]
        rq = _get(srv.url + '/requests?min_failovers=1&outcome=ok')
        assert [e['request_id'] for e in rq['events']] == [1, 2]
        assert _get(srv.url + '/requests?until_ts=2&limit=1')[
            'events'][0]['request_id'] == 1
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(srv.url + '/requests?limit=x')
        assert e.value.code == 400
    with MetricsServer(registry=reg) as bare:
        for route in ('/fleet', '/alerts', '/requests'):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(bare.url + route)
            assert e.value.code == 404


# ---- the gateway's fleet hooks against the JAX gateway ----------------

CFG = dict(vocab_size=211, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=128, dropout=0.0)
MNT = 6
ENGINE_KW = dict(max_len=32, prefill_chunk=8, decode_block=2)


@pytest.fixture(scope='module')
def pair():
    paddle.seed(7)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**CFG))
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**CFG), device='cpu', seed=1)
    tgpt.load_paddle_tpu_state(tm, state)
    return jm, tm.eval()


def _gateway_run(name, model, tmp):
    """A sync gateway of 2 slot replicas with the fleet attached (and the
    gateway's own registry as a target), an autoscaler fed the federated
    TTFT burn, and a tracer with retention; replica 1 partitioned at
    request 3 (its scrape target too); every step on a fake clock
    scrapes, evaluates a threshold rule on fleet_target_up and ticks the
    autoscaler."""
    jax = name == 'jax'
    reg_cls, fed, al, tr, exp = JAX if jax else PORT
    part = (jchaos if jax else chaos).partition
    clock = {'t': 0.0}
    reg = reg_cls()
    tracer = tr.Tracer(registry=reg, retention=tr.TraceRetention(
        registry=reg), recorder=tr.FlightRecorder(dump_dir=tmp,
                                                  registry=reg))
    prev = tr.set_default_tracer(tracer)
    try:
        engine = JSlotEngine if jax else ContinuousBatchingEngine
        policy = (JPolicy if jax else AutoscalePolicy)(
            slo_ttft_s=0.2, window_s=1.0, min_replicas=2, max_replicas=3,
            sustain_s=0.0,
            cooldown_s=100.0)
        gw = (JGateway if jax else ServingGateway)(
            lambda: engine(model, num_slots=2, **ENGINE_KW), replicas=2,
            registry=reg, clock=lambda: clock['t'], autoscaler=policy)
        # the collector's own families (fleet_target_up) on the
        # gateway's registry, which is a target too: the rule reads them
        # in the merged view
        fc = fed.FleetCollector(registry=reg, clock=lambda: clock['t'],
                                tracer=tracer)
        gw.attach_fleet(fc)
        fc.add_target('gateway', registry=reg)
        slo = reg.get('gateway_ttft_seconds').buckets[6]
        gw.burn_source = al.federated_burn_source(fc, slo, window_s=1.0)
        mgr = al.AlertManager(
            [al.ThresholdRule('down', 'fleet_target_up', 0.5, op='<',
                              labels={'instance': 'gw-replica-1'})],
            source=fc.merged, registry=reg_cls(), recorder=tracer.recorder,
            clock=lambda: clock['t'])
        rng = np.random.RandomState(3)
        prompts = [[int(t) for t in rng.randint(0, 211, n)]
                   for n in (3, 17, 7, 12, 5, 9)]
        reqs, ctxs, decisions, edges, k = [], [], [], [], 0
        try:
            while len(reqs) < len(prompts) or any(not r.done for r in reqs):
                clock['t'] = 0.1 * k
                if len(reqs) < len(prompts):
                    if len(reqs) == 3:
                        target = [t for t in fc.targets()
                                  if t.instance == 'gw-replica-1'][0]
                        for ep in (gw.pool[1].endpoint, target.endpoint):
                            ctxs.append(part(ep))
                            ctxs[-1].__enter__()
                    reqs.append(gw.submit(prompts[len(reqs)],
                                          max_new_tokens=MNT))
                gw.step()
                fc.scrape()
                edges.append(mgr.evaluate())
                d = gw.autoscale_tick()
                decisions.append((d.delta, round(
                    reg.get('gateway_slo_burn_rate').value(), 12)))
                k += 1
        finally:
            for c in ctxs:
                c.__exit__(None, None, None)
        moved = [r for r in reqs if r.failovers]
        kept = [tracer.retention.get(r._eng_req._span.trace_id) is not None
                for r in moved]
        return dict(tokens=[r.tokens for r in reqs],
                    history=[r.replica_history for r in reqs],
                    targets=sorted(t.instance for t in fc.targets()),
                    decisions=decisions, edges=edges, kept=kept,
                    dumps=len(glob.glob(os.path.join(
                        tmp, 'flight_alert_firing_*'))))
    finally:
        tr.set_default_tracer(prev)


@pytest.mark.chaos
def test_gateway_fleet_and_burn_source_equal_jax(pair, tmp_path):
    """The JAX gateway and the port's, fleet-wired as _gateway_run says:
    equal tokens, placements, scrape targets (an autoscaled replica
    self-registers), autoscaler decisions and burn values, alert edges,
    one dump for the one firing edge, and every failed-over request's
    trace retained."""
    jm, tm = pair
    jax = _gateway_run('jax', jm, str(tmp_path / 'jax'))
    port = _gateway_run('port', tm, str(tmp_path / 'port'))
    assert port == jax
    assert any(len(h) > 1 for h in port['history'])
    assert port['kept'] and all(port['kept'])
    assert port['dumps'] == 1
    assert 'gw-replica-2' in port['targets']


def test_dryrun_snapshot_line_against_jax():
    """dryrun_registry holds every family of the JAX package's but the
    JAX runtime sampler's and the engines' trace canary (the port samples
    CUDA memory and kernel builds instead); its snapshot_line parses with
    either package's parse_snapshot_lines, as tools/perf_report.py reads
    it."""
    from paddle_tpu.monitor import telemetry as jtel
    from paddle_tpu_torch.monitor import telemetry as ttel
    jfams = set(jexport.to_dict(jtel.dryrun_registry(0.25, 2.0, batch=8)))
    reg = ttel.dryrun_registry(0.25, 2.0, batch=8)
    tfams = set(texport.to_dict(reg))
    assert jfams - tfams == {'jax_device_count', 'jax_live_array_bytes',
                             'jax_live_array_count',
                             'jax_trace_cache_entries',
                             'serving_trace_count'}
    assert tfams - jfams == {'cuda_allocated_bytes', 'cuda_device_count',
                             'cuda_reserved_bytes', 'kernel_builds'}
    line = ttel.snapshot_line(reg, 8, '[dp/mp]')
    parsed = jtel.parse_snapshot_lines('noise\n' + line + '\n')
    assert parsed == ttel.parse_snapshot_lines(line)
    snap = parsed['dp/mp']
    assert snap['train_examples_per_second']['samples'][0]['value'] == 32.0
    assert set(snap) == tfams
