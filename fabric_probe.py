"""Split where the serving fabric's QoS replay loses time, on one NVIDIA GPU.

    python3 fabric_probe.py

chip_smoke's phase 16a runs the QoS replay through 2 worker processes of
the gpt-bench preset (bf16, slot engines of 8 x 256, chunk 32, 8-step
bursts). This probe measures, on the same configuration:

1. one submission's wall time (ServingGateway.submit, until the replica
   has admitted the request) to worker processes and to an in-process
   replica, while the replicas are idle and while every slot decodes;
2. the QoS replay (chip_smoke's trace and policy) through 2 worker
   processes and through 1 in-process replica, every submit timed.

Prints one line per measurement: submit p50 / p99 / max, and for the
replays tokens/s, the submit lag and the wall time. Exits non-zero
without CUDA.
"""
import sys
import time

import torch

import chip_smoke as cs

N_TIMED = 12


def _pcts(xs):
    return 'p50 %.1f ms p99 %.1f ms max %.1f ms (%d submits)' % (
        cs._pct([x * 1e3 for x in xs], 50), cs._pct([x * 1e3 for x in xs],
                                                    99),
        max(xs) * 1e3, len(xs))


def _timed(gw):
    """Record the wall time of every gw.submit() call."""
    times, submit = [], gw.submit

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = submit(*args, **kwargs)
        times.append(time.perf_counter() - t0)
        return out
    gw.submit = timed
    return times


def submit_times(gw, vocab, label):
    """Submits to idle replicas, then with every slot decoding."""
    gen = torch.Generator().manual_seed(7)

    def prompt():
        return torch.randint(0, vocab, (32,), generator=gen).tolist()
    gw.generate([prompt()], max_new_tokens=2)        # warm
    gw.start()
    times = _timed(gw)
    for _ in range(N_TIMED):
        gw.submit(prompt(), max_new_tokens=2).wait(60)
    idle = list(times)
    del times[:]
    fill = [gw.submit(prompt(), max_new_tokens=200)
            for _ in range(8 * len(gw.pool))]
    time.sleep(0.5)                                 # all slots decoding
    busy = [gw.submit(prompt(), max_new_tokens=2) for _ in range(N_TIMED)]
    busy_times = times[len(fill):]
    for h in fill + busy:
        h.wait(300)
    gw.shutdown(timeout=60)
    print('%s submit, idle: %s; while every slot decodes: %s'
          % (label, _pcts(idle), _pcts(busy_times)), flush=True)


def replay_times(make_gateway, trace, label):
    times = []

    def make(policy):
        gw = make_gateway(policy)
        times.append(_timed(gw))
        return gw
    gw, res, _, _ = cs._qos_replay(make, trace)
    gw.shutdown(timeout=60)
    replay_submits = times[0][-len(trace):]
    print('%s QoS replay: %.0f tokens/s (%d tokens in %.2f s), max submit '
          'lag %.1f ms; submit %s' % (label, res.tokens_per_sec, res.tokens,
                                      res.wall_s, res.max_lag_s * 1e3,
                                      _pcts(replay_submits)), flush=True)


def main():
    if not torch.cuda.is_available():
        print('fabric_probe: CUDA is not available', file=sys.stderr)
        return 1
    from paddle_tpu_torch.monitor.registry import MetricRegistry
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          ServingGateway)
    from paddle_tpu_torch.serving.fabric.presets import build_model, preset

    print(cs._nvidia_smi(), flush=True)
    vocab = preset(cs.FABRIC_PRESET)['model']['vocab_size']
    trace = cs._qos_trace(vocab)[0]
    model = build_model(cs.FABRIC_PRESET, dtype='bfloat16')

    def inproc(policy=None):
        def factory():
            return ContinuousBatchingEngine(model, num_slots=8, max_len=256,
                                            prefill_chunk=32, decode_block=8)
        return ServingGateway(factory, replicas=1, admission=policy,
                              registry=MetricRegistry())

    # one worker for the submit timings (its gateway drains it), two for
    # the replay
    handles = cs._spawn_workers([dict(preset=cs.FABRIC_PRESET,
                                      dtype='bfloat16')] * 3)
    try:
        submit_times(cs._fabric_gateway(handles[:1]), vocab,
                     '1 worker process')
        submit_times(inproc(), vocab, '1 in-process replica')
        replay_times(lambda p: cs._fabric_gateway(handles[1:], admission=p),
                     trace, '2 worker processes')
        replay_times(inproc, trace, '1 in-process replica')
    finally:
        for h in handles:
            h.cleanup()
    return 0


if __name__ == '__main__':
    sys.exit(main())
