"""Train the bench GPT under fleet's strategies across the cards of one host.

    python3 fleet_probe.py               # every card of the host
    python3 fleet_probe.py --nprocs 2
    python3 fleet_probe.py --strategies pp,pp_1f1b,dp_pp,ep,dp_ep
    python3 fleet_probe.py --teardown-check   # how the ranks exit

One rank a card (paddle_tpu_torch.distributed.spawn: the PADDLE_TRAINER_*
env, NCCL on card = rank), held by chip_smoke's phase-22 yardstick
(_fleet_strategy, _fleet_run, _update_rel, _fleet_check). Each rank
trains chip_smoke's phase-6 model (the bench GPT: vocab 30528, hidden 768,
12 layers of 12 heads, fused loss, AdamW lr 1e-4) from the same seeded
weights on the same global batch (32 x 512), FLEET_STEPS steps: the
plain TrainStep on its own card, then fleet.fleet_train_step under each
strategy of STRATEGIES; all of it first in f32, then in bf16, from the
same weights. The pipeline strategies ('pp' GPipe and 'pp_1f1b' over
every card, 'dp_pp') keep each rank's stage; a rank's update_rel covers
the parameters it holds. Then the MoE GPT of chip_smoke's phase 25 (c)
(8 SwitchMoE experts in every block at Switch-Base width, batch 16 x
512) in f32 under MOE_STRATEGIES ('ep' over every card: each rank holds
8 / ep experts; 'dp_ep'), against its plain step on one card.

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
import threading
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as smoke  # noqa: E402

STRATEGIES = ('dp', 'dp_sharding3', 'sharding1', 'mp', 'dp_mp', 'sp_ring',
              'sp_zigzag', 'sp_ulysses', 'pp', 'pp_1f1b', 'dp_pp')
MOE_STRATEGIES = ('ep', 'dp_ep')
TEARDOWN_S = 60


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


def rank_main(only=None):
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
             if all(v <= world for v in _degrees(n, world).values())
             and (not only or n in only)]
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
    del base16, base32, exact, ref
    torch.cuda.empty_cache()
    moe_probe(rank, world, check, only)
    # spawn ends the rank's NCCL groups when this returns
    # (end_nccl_groups); should that not return, the rank leaves with 3
    _deadline(TEARDOWN_S, 'the NCCL teardown')
    if failed:
        raise RuntimeError('fleet_probe: %d checks failed on rank %d:\n%s'
                           % (len(failed), rank, '\n'.join(failed)))


def _deadline(seconds, what):
    """Leave the process with exit code 3 unless it has ended within
    `seconds`."""
    def leave():
        print('fleet_probe: %s did not return in %d s' % (what, seconds),
              file=sys.stderr, flush=True)
        os._exit(3)
    timer = threading.Timer(seconds, leave)
    timer.daemon = True
    timer.start()


def _teardown_rank(env, end, p2p):
    """A rank of the teardown check: the default group and a pp mesh's
    groups, a few all-reduces, with p2p a pipeline's exchanges (a send to
    the next stage and a receive from the previous, batch_isend_irecv on
    the default group, as distributed/pipeline.py's _Wire), then `end`:
    'exit' (the interpreter's exit), 'destroy'
    (torch.distributed.destroy_process_group after a barrier) or 'port'
    (distributed.env.end_nccl_groups)."""
    os.environ.update(env)
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import env as env_mod
    dist.init_parallel_env()
    rank, world = dist.get_rank(), dist.get_world_size()
    hcg = dist.HybridCommunicateGroup(pp_degree=world)
    x = torch.ones(1 << 20, device='cuda')
    for _ in range(3):
        torch.distributed.all_reduce(x)
        torch.distributed.all_reduce(
            x, group=hcg.mesh.get_group('pp'))
    if p2p:
        nxt, prev = (rank + 1) % world, (rank - 1) % world
        for _ in range(3):
            got = torch.empty_like(x)
            ops = [torch.distributed.P2POp(torch.distributed.isend, x, nxt),
                   torch.distributed.P2POp(torch.distributed.irecv, got,
                                           prev)]
            for work in torch.distributed.batch_isend_irecv(ops):
                work.wait()
    torch.cuda.synchronize()
    if end == 'destroy':
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    elif end == 'port':
        env_mod.end_nccl_groups()


def teardown_check(world, seconds):
    """Whether `world` ranks exit within `seconds` after NCCL traffic,
    for each way of ending (_teardown_rank): one JSON line each."""
    import importlib
    import multiprocessing as mp
    spawn_mod = importlib.import_module('paddle_tpu_torch.distributed.spawn')
    ctx = mp.get_context('spawn')
    ok = True
    for end, p2p in (('exit', False), ('exit', True), ('destroy', True),
                     ('port', True)):
        ports = spawn_mod._free_ports(world)
        procs = [ctx.Process(target=_teardown_rank, args=(
            spawn_mod._rank_env(r, world, ports, {}), end, p2p))
            for r in range(world)]
        t0 = time.time()
        for p in procs:
            p.start()
        for p in procs:
            p.join(max(0.0, seconds - (time.time() - t0)))
        hung = [p.is_alive() for p in procs]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        clean = not any(hung) and codes == [0] * world
        ok = ok and (clean or end != 'port')
        print(json.dumps({'teardown': end, 'p2p': p2p, 'world': world,
                          'clean_exit': clean, 'exitcodes': codes,
                          'seconds': time.time() - t0}), flush=True)
    return ok


def moe_probe(rank, world, check, only=None):
    """The MoE GPT in f32 under MOE_STRATEGIES against its plain step."""
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM
    names = [n for n in MOE_STRATEGIES if not only or n in only]
    if not names:
        return
    cfg = smoke._moe_config()
    gen = torch.Generator().manual_seed(smoke.SEED + 27)
    ids, labels = (torch.randint(0, cfg.vocab_size, (smoke.MOE_BATCH,
                                                     smoke.TRAIN_SEQ),
                                 generator=gen).cuda() for _ in range(2))
    base = GPTForCausalLM(cfg, device='cuda', seed=smoke.SEED)
    plain = smoke._fleet_run('plain', base, ids, labels)
    exact = plain.pop('final')
    _peaks(plain, world)
    if rank == 0:
        print(_line('plain', world, 'float32 moe', plain, plain, {}),
              flush=True)
    for name in names:
        if any(v > world for v in _degrees(name, world).values()):
            continue
        run = smoke._fleet_run(name, base, ids, labels, ref=exact,
                               world=world)
        check(name + ' (MoE f32)', run, plain)
        _peaks(run, world)
        if rank == 0:
            print(_line(name, world, 'float32 moe', run, plain, {}),
                  flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--nprocs', type=int, default=0,
                    help='ranks, one a card (default: every card)')
    ap.add_argument('--strategies', default='',
                    help='comma-separated names of STRATEGIES and '
                    'MOE_STRATEGIES to run (default: all)')
    ap.add_argument('--teardown-check', action='store_true',
                    help='only check how the ranks exit after NCCL '
                    'traffic (teardown_check)')
    args = ap.parse_args()
    only = tuple(n for n in args.strategies.split(',') if n)
    if not torch.cuda.is_available():
        print('fleet_probe: CUDA is not available', file=sys.stderr)
        return 1
    nprocs = args.nprocs or torch.cuda.device_count()
    print(smoke._nvidia_smi(), 'x %d' % nprocs, flush=True)
    print('torch %s, CUDA %s' % (torch.__version__, torch.version.cuda),
          flush=True)
    if args.teardown_check:
        return 0 if teardown_check(nprocs, TEARDOWN_S) else 1
    t0 = time.time()
    from paddle_tpu_torch import _build
    _build.build(['flash_fwd', 'flash_bwd'])
    print('build: %.1f s' % (time.time() - t0), flush=True)
    from paddle_tpu_torch.distributed import spawn
    spawn(rank_main, args=(only,), nprocs=nprocs,
          env={'OMP_NUM_THREADS': '1'})
    print('fleet_probe: %.1f s' % (time.time() - t0), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
