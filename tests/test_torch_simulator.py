"""The port's discrete-event fleet simulator
(paddle_tpu_torch/capacity/simulator.py) against the JAX package's, on
the CPU: with the same traces (the same seed through both packages'
workload generators) and service models, every simulation, sweep,
calibration and divergence equals the JAX simulator's bit for bit.
"""
import numpy as np
import pytest

from paddle_tpu.capacity import qos as jqos
from paddle_tpu.capacity import simulator as jsim
from paddle_tpu.capacity import workload as jwork
from paddle_tpu.serving.gateway.autoscaler import AutoscalePolicy as JPolicy
from paddle_tpu_torch.capacity import qos as tqos
from paddle_tpu_torch.capacity import simulator as tsim
from paddle_tpu_torch.capacity import workload as twork
from paddle_tpu_torch.monitor import export as texport
from paddle_tpu.monitor import export as jexport
from paddle_tpu.monitor.registry import MetricRegistry as JRegistry
from paddle_tpu_torch.monitor.registry import MetricRegistry
from paddle_tpu_torch.serving.gateway.autoscaler import AutoscalePolicy

JAX = (jsim, jwork, jqos, JPolicy, JRegistry, jexport)
PORT = (tsim, twork, tqos, AutoscalePolicy, MetricRegistry, texport)


def _spec(work, n=300, gap=0.002, **kw):
    base = dict(requests=n, seed=11, vocab_size=512,
                arrival={'process': 'poisson', 'mean_gap_s': gap},
                lengths={'dist': 'ladder', 'lens': [8, 16, 24, 64]},
                output={'dist': 'fixed', 'len': 24},
                tenants={'mode': 'round_robin', 'tenants': [
                    {'name': 'premium'}, {'name': 'bg'}]})
    base.update(kw)
    return work.WorkloadSpec(**base)


def _strip(obj):
    """obj without its host wall-clock fields (wall_s, sim_wall_s): the
    one thing a simulation reads from the machine it runs on."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items()
                if k not in ('wall_s', 'sim_wall_s')}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_strip(v) for v in obj)
    return obj


def _result(res):
    """Everything a SimResult carries, as plain data."""
    out = {k: getattr(res, k) for k in ('admit', 'first', 'finish',
                                        'failovers', 'replica_of')}
    out = {k: np.asarray(v).tolist() for k, v in out.items()}
    out['events'] = res.to_events()
    out['p'] = res.ttft_percentiles((50, 99))
    out['by_prio'] = res.ttft_percentiles_by_priority()
    out['summary'] = _strip(res.summary(slo_ttft_s=0.05))
    out['max_replicas'] = res.max_replicas
    return out


@pytest.mark.parametrize('case', ['plain', 'kill', 'policy', 'qos',
                                  'prefix'])
def test_simulate_equals_jax(case):
    runs = []
    for sim, work, qos, pol, reg_cls, exp in (JAX, PORT):
        kw = {}
        spec = _spec(work)
        if case == 'prefix':
            spec = _spec(work, lengths={'dist': 'fixed', 'len': 8},
                         prefix={'len': 64, 'groups': 2, 'prob': 1.0})
        tr = work.generate(spec)
        model = sim.ServiceModel(prefill_chunk_s=0.002, decode_burst_s=0.004)
        if case == 'kill':
            kw['kill_at'] = {1: tr.duration_s / 2}
        if case == 'policy':
            kw['policy'] = pol(slo_ttft_s=0.02, min_replicas=1,
                               max_replicas=6, sustain_s=0.2,
                               cooldown_s=0.5, window_s=2.0)
        if case == 'qos':
            kw['qos'] = qos.QosPolicy(classes=[
                qos.TenantClass('premium', priority=1),
                qos.TenantClass('bg', rate=50.0, burst=5.0)])
        reg = reg_cls()
        res = sim.simulate(tr, model, replicas=2 if case != 'policy' else 1,
                           registry=reg, **kw)
        fams = exp.to_dict(reg)
        runs.append((_result(res), {n: fams[n] for n in fams
                                    if n.startswith('sim_')}))
    assert runs[1] == runs[0]


def test_sweeps_and_calibration_equal_jax():
    """sweep_replicas, min_replicas_for, sweep_qos (host wall times
    aside),
    ServiceModel.from_events (with the bisection on the measured trace),
    from_roofline on the same peak, from_bench_rows, ttft_divergence and
    compare_events: equal."""
    runs = []
    for sim, work, qos, _, _, _ in (JAX, PORT):
        tr = work.generate(_spec(work, n=400))
        model = sim.ServiceModel(prefill_chunk_s=0.002, decode_burst_s=0.004)
        sweep = sim.sweep_replicas(tr, model, counts=(1, 2, 4),
                                   slo_ttft_s=0.05)
        real = sim.simulate(tr, model, replicas=2).to_events()
        fitted = sim.ServiceModel.from_events(real, prefill_chunk=32,
                                              decode_block=8, trace=tr,
                                              replicas=2)
        fitted2 = sim.ServiceModel.from_events(real)
        roof = sim.ServiceModel.from_roofline(
            1e8, 2e8, platform='cpu')
        rows = [{'metric': 'serving_cb_tokens_per_sec', 'value': 1000.0,
                 'num_slots': 8}]
        sim2 = sim.simulate(tr, fitted, replicas=2)
        policies = [('rate%d' % r, qos.QosPolicy(classes=[
            qos.TenantClass('premium', priority=1),
            qos.TenantClass('bg', rate=r, burst=4.0)]))
            for r in (20.0, 200.0)]
        qsweep = sim.sweep_qos(tr, model, policies, replicas=2,
                               slo_ttft_s=0.05)
        runs.append(dict(
            sweep=sweep, fitted=fitted.to_dict(), fitted2=fitted2.to_dict(),
            roof=roof.to_dict(),
            bench=sim.ServiceModel.from_bench_rows(rows).to_dict(),
            div=sim.ttft_divergence(sim2.ttft(), sim.ttfts_of_events(real)),
            cmp=sim.compare_events(sim2.to_events(), real),
            min_r=sim.min_replicas_for(tr, model, 0.05, counts=(1, 2, 4)),
            qsweep=qsweep))
    for key in runs[0]:
        assert _strip(runs[1][key]) == _strip(runs[0][key]), key


def test_from_roofline_reads_the_port_peaks():
    """from_roofline on the card's datasheet row: the decode burst is the
    weights streamed at the H100's 3.35 TB/s, the prefill chunk its
    FLOPs at 989 TFLOP/s when those dominate."""
    m = tsim.ServiceModel.from_roofline(1e8, 2e8, platform='H100',
                                        prefill_chunk=4096, decode_block=8,
                                        num_slots=8)
    assert m.decode_burst_s == pytest.approx(8 * 2e8 / 3.35e12)
    assert m.prefill_chunk_s == pytest.approx(2e8 * 4096 / 989e12)
