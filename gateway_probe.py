"""Split where two in-process gateway replicas lose time, on one NVIDIA GPU.

    python3 gateway_probe.py

chip_smoke's QoS phase found two ServingGateway replicas in one process
slower than one. This probe takes that configuration (the JAX package's
QoS rung at full width: bf16 GPT, vocab 30528, 768 x 12 x 12, engines of
8 slots x 256, chunk 32, 8-step decode bursts) and measures, in one
process:

1. bare bursts: each engine's decode burst with all 8 slots decoding,
   timed alone, then two engines bursting at once from two threads (no
   gateway, no replay), at torch's default CPU thread count and at 1;
2. the QoS replay (chip_smoke's trace and policy) through the gateway on
   1 and 2 replicas, under the interpreter's default switch interval and
   at 50 ms, in turns and then in the reverse order.

Prints one line per measurement: tokens/s, the replay's submit lag, each
replica's burst p50 split into host dispatch and the wait for the card.
Exits non-zero without CUDA.
"""
import sys
import threading
import time

import torch

import chip_smoke as cs

SLOTS, MAX_LEN, CHUNK, BLOCK = 8, 256, 32, 8
BURSTS = 12


def _engine(model):
    from paddle_tpu_torch.serving import ContinuousBatchingEngine
    return ContinuousBatchingEngine(model, num_slots=SLOTS, max_len=MAX_LEN,
                                    prefill_chunk=CHUNK, decode_block=BLOCK)


def _fill(eng, gen, vocab):
    """All slots decoding, with room for BURSTS more bursts."""
    for _ in range(SLOTS):
        eng.add_request(torch.randint(0, vocab, (32,), generator=gen).tolist(),
                        max_new_tokens=MAX_LEN - 32)
    while eng.scheduler.queue or any(
            r.state != 'decode' for r in eng.scheduler.resident.values()):
        eng.step()


def _bursts(eng, out):
    """Wall times (s) of BURSTS decode bursts of `eng`, each ending in its
    read-back of the tokens."""
    for _ in range(BURSTS):
        t0 = time.perf_counter()
        with eng._lock, torch.no_grad():
            eng._decode_step()
        out.append(time.perf_counter() - t0)


def bare_bursts(model, vocab):
    gen = torch.Generator().manual_seed(cs.SEED + 7)
    default_threads = torch.get_num_threads()
    for threads in (default_threads, 1):
        torch.set_num_threads(threads)
        engines = [_engine(model), _engine(model)]
        for eng in engines:
            _fill(eng, gen, vocab)
        alone = []
        _bursts(engines[0], alone)
        pair = [[], []]
        ts = [threading.Thread(target=_bursts, args=(e, o))
              for e, o in zip(engines, pair)]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        for t in ts:
            t.join(600)
        wall = time.perf_counter() - t0
        cs._check(not any(t.is_alive() for t in ts), 'a burst thread hung')
        torch.cuda.synchronize()
        print('bare bursts (8 slots, 8 steps), torch CPU threads %d: alone '
              'p50 %.2f ms; two engines at once p50 %.2f / %.2f ms, %d '
              'bursts each in %.2f s' % (
                  threads, cs._pct(alone, 50) * 1e3,
                  cs._pct(pair[0], 50) * 1e3, cs._pct(pair[1], 50) * 1e3,
                  BURSTS, wall), flush=True)
        del engines
        torch.cuda.empty_cache()
    torch.set_num_threads(default_threads)


def replays(model, trace):
    default_interval = sys.getswitchinterval()
    runs = [(1, default_interval), (2, default_interval), (2, 0.05),
            (1, 0.05)]
    for replicas, interval in runs + runs[::-1]:
        sys.setswitchinterval(interval)
        try:
            gw, res, events = cs._qos_run(model, trace, replicas=replicas)
            gw.shutdown()
        finally:
            sys.setswitchinterval(default_interval)
        shed = sum(1 for h in res.handles if h.error is not None)
        print('replay, %d replica(s), switch interval %.3f s: %.0f tokens/s '
              '(%d tokens in %.2f s), max submit lag %.1f ms, shed %d; burst '
              'p50 %s' % (replicas, interval, res.tokens_per_sec, res.tokens,
                          res.wall_s, res.max_lag_s * 1e3, shed,
                          cs._burst_split(gw)), flush=True)
        del gw
        torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        print('gateway_probe: CUDA is not available', file=sys.stderr)
        return 1
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    print(cs._nvidia_smi(), flush=True)
    cfg = GPTConfig(vocab_size=30528, hidden_size=768, num_layers=12,
                    num_heads=12, max_position_embeddings=1024, dropout=0.0)
    model = GPTForCausalLM(cfg, device='cuda', seed=cs.SEED).eval().bfloat16()
    trace = cs._qos_trace(cfg.vocab_size)[0]
    bare_bursts(model, cfg.vocab_size)
    replays(model, trace)
    return 0


if __name__ == '__main__':
    sys.exit(main())
