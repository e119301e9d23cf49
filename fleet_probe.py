"""Train the bench GPT under fleet's strategies across the cards of one host.

    python3 fleet_probe.py               # every card of the host
    python3 fleet_probe.py --nprocs 2

One rank a card (paddle_tpu_torch.distributed.spawn: the PADDLE_TRAINER_*
env, NCCL on card = rank), held by chip_smoke's phase-22 yardstick
(_fleet_strategy, _fleet_run, _update_rel, _fleet_check). Each rank
trains chip_smoke's phase-6 model (the bench GPT: vocab 30528, hidden 768,
12 layers of 12 heads, fused loss, AdamW lr 1e-4) from the same seeded
weights on the same global batch (32 x 512), FLEET_STEPS steps: the
plain TrainStep on its own card, then fleet.fleet_train_step under each
strategy of STRATEGIES; all of it first in f32, then in bf16, from the
same weights.

Checks (a failure exits non-zero, after every strategy has run):
- bf16: the losses within FLEET_LOSS_RTOL of the bf16 plain step's;
- f32: the losses as in bf16, and update_rel (the parameters after the
  steps against the f32 plain step's, |theta - theta_plain| /
  |theta_plain - theta_0|) within FLEET_UPDATE_RTOL, the bound phase 22
  holds each strategy to at world 1. In f32 another order of sums moves
  a parameter by far less than its update; in bf16 it flips roundings of
  the parameters themselves, so the bf16 update_rel is printed beside
  the drift of each bf16 run from the f32 plain step (the plain bf16
  step's drift for scale), and not checked.
Rank 0 prints one JSON line a strategy and precision: losses, update_rel
with its three largest parameters, the p50 step time over steps 2 to
FLEET_STEPS (host clock around a synchronised step), flash launches a
step on rank 0 by entry (the zigzag ring computes in torch ops and counts
none) and each rank's peak memory. The card's name and power limit lead
the output.
"""
import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as smoke  # noqa: E402

STRATEGIES = ('dp', 'dp_sharding3', 'sharding1', 'mp', 'dp_mp', 'sp_ring',
              'sp_zigzag', 'sp_ulysses')


def _degrees(name, world):
    deg = smoke._fleet_strategy(name, world).hybrid_configs
    return {k: v for k, v in deg.items() if v > 1}


def _line(name, world, dtype, run, plain, extra):
    launches = {k: v for k, v in run['launches'][-1].items() if v}
    return json.dumps(dict({
        'strategy': name, 'world': world, 'dtype': dtype,
        'degrees': _degrees(name, world) if name != 'plain' else {},
        'losses': run['losses'], 'plain_losses': plain['losses'],
        'loss_rel': run.get('loss_rel'), 'update_rel': run.get('update_rel'),
        'worst_params': run.get('worst_params'), 'p50_ms': run['p50_ms'],
        'plain_p50_ms': plain['p50_ms'], 'launches_a_step_rank0': launches,
        'peak_gib': run['peak_gib_ranks']}, **extra))


def _peaks(run, world):
    peaks = [None] * world
    torch.distributed.all_gather_object(peaks, round(run['peak_gib'], 3))
    run['peak_gib_ranks'] = peaks


def rank_main():
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    import paddle_tpu_torch.distributed as dist

    torch.set_num_threads(4)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_parallel_env()
    rank, world = dist.get_rank(), dist.get_world_size()
    cfg = GPTConfig(**smoke.BENCH_CFG)
    gen = torch.Generator().manual_seed(smoke.SEED)
    ids = torch.randint(0, cfg.vocab_size, (smoke.TRAIN_BATCH,
                                            smoke.TRAIN_SEQ), generator=gen)
    labels = torch.randint(0, cfg.vocab_size, (smoke.TRAIN_BATCH,
                                               smoke.TRAIN_SEQ),
                           generator=gen)
    ids, labels = ids.cuda(), labels.cuda()
    base16 = GPTForCausalLM(cfg, device='cuda', seed=smoke.SEED).to(
        torch.bfloat16)
    names = [n for n in STRATEGIES
             if all(v <= world for v in _degrees(n, world).values())]
    failed = []

    def check(name, run, plain, **kwargs):
        try:
            smoke._fleet_check(name, run, plain, **kwargs)
        except RuntimeError as e:
            failed.append(str(e))

    # f32 first: its plain run's parameters are the bf16 runs' drift
    # reference
    base32 = smoke._fresh_bench_model(base16).float()
    plain32 = smoke._fleet_run('plain', base32, ids, labels)
    exact = plain32.pop('final')
    _peaks(plain32, world)
    if rank == 0:
        print(_line('plain', world, 'float32', plain32, plain32, {}),
              flush=True)
    for name in names:
        run = smoke._fleet_run(name, base32, ids, labels, ref=exact,
                               world=world)
        check(name + ' (f32)', run, plain32)
        _peaks(run, world)
        if rank == 0:
            print(_line(name, world, 'float32', run, plain32, {}),
                  flush=True)
    plain16 = smoke._fleet_run('plain', base16, ids, labels)
    ref = plain16.pop('final')
    drift = smoke._update_rel(ref, exact, base32)['update_rel']
    _peaks(plain16, world)
    if rank == 0:
        print(_line('plain', world, 'bfloat16', plain16, plain16,
                    {'drift_from_f32_plain': drift}), flush=True)
    for name in names:
        run = smoke._fleet_run(name, base16, ids, labels, world=world)
        final = run.pop('final')
        run.update(smoke._update_rel(final, ref, base16))
        extra = {'drift_from_f32_plain':
                 smoke._update_rel(final, exact, base32)['update_rel'],
                 'plain_drift_from_f32_plain': drift}
        del final
        check(name + ' (bf16)', run, plain16, update_rtol=float('inf'))
        _peaks(run, world)
        if rank == 0:
            print(_line(name, world, 'bfloat16', run, plain16, extra),
                  flush=True)
    torch.distributed.destroy_process_group()
    if failed:
        raise RuntimeError('fleet_probe: %d checks failed:\n%s'
                           % (len(failed), '\n'.join(failed)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--nprocs', type=int, default=0,
                    help='ranks, one a card (default: every card)')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('fleet_probe: CUDA is not available', file=sys.stderr)
        return 1
    nprocs = args.nprocs or torch.cuda.device_count()
    print(smoke._nvidia_smi(), 'x %d' % nprocs, flush=True)
    print('torch %s, CUDA %s' % (torch.__version__, torch.version.cuda),
          flush=True)
    t0 = time.time()
    from paddle_tpu_torch import _build
    _build.build(['flash_fwd', 'flash_bwd'])
    print('build: %.1f s' % (time.time() - t0), flush=True)
    from paddle_tpu_torch.distributed import spawn
    spawn(rank_main, nprocs=nprocs, env={'OMP_NUM_THREADS': '1'})
    print('fleet_probe: %.1f s' % (time.time() - t0), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
