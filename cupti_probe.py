"""Find where torch.profiler loses kernels of the bf16 bench step on one
NVIDIA GPU.

    python3 cupti_probe.py [--trials 2] [--busy-seconds 90]
                           [--stages early,late] [--disciplines A,B]
                           [--out FILE]

Builds the flash kernels, sets up chip_smoke's bf16 bench TrainStep
(GPT-2 small width, 12 layers, batch 32 x 512) and profiles two steps
with paddle_tpu_torch.profiler.Profiler under each start discipline:

- ``cold``: the trace starts and the first recorded step follows at once
  (no warm-up);
- ``sync_sleep``: as cold, with a device synchronize and 0.5 s of sleep
  between the trace's start and the first recorded step;
- ``warmup``: a traced warm-up step that is thrown away
  (``scheduler=(1, 3)``), then the two recorded steps (chip_smoke's
  phase 24 (a));
- ``warm_sync``: as warmup, with a device synchronize before the trace
  starts;
- ``pad`` and ``warm_pad``: as cold and warmup, with the Profiler's own
  pad at the start of the recording window (``profiler.PAD_LAUNCHES``
  device sleeps of ~0.3 ms each), so the step's launches come after that
  many launches and ~20 ms of device time. The other disciplines set
  ``PAD_LAUNCHES`` to 0 for their trace.

The disciplines take turns, ``--trials`` rounds of each, in every stage
of ``--stages``: ``early`` right after the set-up, ``late`` after the
step has run untraced for ``--busy-seconds`` (a process that has run for
minutes, as chip_smoke's phase 24 is); ``--stages late`` traces nothing
before the busy run. For
every trace it reads the exported Chrome trace: the host's kernel
launches (runtime or driver events named ``*LaunchKernel*``), the device
kernels, and the launches whose correlation id has no kernel. It prints,
per trace, the flash kernels found against the 12 a step launched, the
lost launches' positions in launch order with their host time after the
first recorded launch (``lost_step``: those past the pad), and the least
device-start-minus-launch gap of the pairs found (a negative gap would
mean the two clocks disagree). One JSON
line sums it up, and ``--out`` keeps every trace's figures.
"""
import argparse
import collections
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

import chip_smoke as cs
from paddle_tpu_torch import _build
from paddle_tpu_torch import profiler as prof_mod
from paddle_tpu_torch.text.models.gpt import GPTConfig

DISCIPLINES = ('cold', 'sync_sleep', 'warmup', 'warm_sync', 'pad',
               'warm_pad')
PAD_LAUNCHES = prof_mod.PAD_LAUNCHES


def _analyse(path, layers, steps, pad):
    with open(path) as fh:
        trace = json.load(fh)
    events = trace['traceEvents']
    n_launch, lost = cs._lost_launches(trace)
    launches = {e['args'].get('correlation'): e for e in events
                if e.get('cat') in ('cuda_runtime', 'cuda_driver')
                and 'LaunchKernel' in e.get('name', '')}
    kernels = [e for e in events if e.get('cat') == 'kernel']
    gaps = [k['ts'] - launches[k['args']['correlation']]['ts']
            for k in kernels if k['args'].get('correlation') in launches]
    flash = collections.Counter()
    for k in kernels:
        for name in cs.FLASH_TRAIN_KERNELS:
            if name in k['name']:
                flash[name] += 1
    return {'launches': n_launch, 'kernels': len(kernels),
            'lost': len(lost), 'lost_step': sum(i >= pad for i, _ in lost),
            'lost_at': [(i, round(t, 1)) for i, t in lost[:12]],
            'flash': dict(flash), 'flash_want': steps * layers,
            'flash_ok': all(flash[n] == steps * layers
                            for n in cs.FLASH_TRAIN_KERNELS),
            'min_gap_us': round(min(gaps), 1) if gaps else None}


def _profile(step, ids, labels, discipline, tmp, layers):
    warm = discipline in ('warmup', 'warm_sync', 'warm_pad')
    pad = PAD_LAUNCHES if discipline in ('pad', 'warm_pad') else 0
    if discipline == 'warm_sync':
        torch.cuda.synchronize()
    prof_mod.PAD_LAUNCHES = pad
    try:
        prof = prof_mod.Profiler(log_dir=tmp,
                                 scheduler=(1, 3) if warm else None)
        with prof:
            if discipline == 'sync_sleep':
                torch.cuda.synchronize()
                time.sleep(0.5)
            for _ in range(3 if warm else 2):
                step(ids, labels).item()
                prof.step()
    finally:
        prof_mod.PAD_LAUNCHES = PAD_LAUNCHES
    out = _analyse(prof.trace_path, layers, 2, pad)
    os.remove(prof.trace_path)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--trials', type=int, default=2)
    ap.add_argument('--busy-seconds', type=float, default=90.0)
    ap.add_argument('--stages', default='early,late')
    ap.add_argument('--disciplines', default=','.join(DISCIPLINES))
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('cupti_probe: no CUDA device')
    t0 = time.time()
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip()
    print('card: %s; torch %s, CUDA %s' % (smi, torch.__version__,
                                          torch.version.cuda), flush=True)
    _build.build(['flash_fwd', 'flash_bwd'])
    cfg = GPTConfig(**cs.BENCH_CFG)
    _, step, ids, labels = cs._train_setup(
        cfg, 'cuda', cs.SEED, cs.TRAIN_BATCH, cs.TRAIN_SEQ, torch.bfloat16)
    for _ in range(3):
        step(ids, labels).item()
    tmp = tempfile.mkdtemp(prefix='cupti_probe_')
    rows = []
    try:
        for stage in args.stages.split(','):
            if stage == 'late':
                t1 = time.time()
                n = 0
                while time.time() - t1 < args.busy_seconds:
                    step(ids, labels).item()
                    n += 1
                print('busy: %d untraced steps in %.1f s' % (
                    n, time.time() - t1), flush=True)
            for trial in range(args.trials):
                for d in args.disciplines.split(','):
                    r = _profile(step, ids, labels, d, tmp, cfg.num_layers)
                    r.update(stage=stage, trial=trial, discipline=d,
                             process_s=round(time.time() - t0, 1))
                    rows.append(r)
                    print('%-5s %-10s trial %d at %6.1f s: flash %s (want '
                          '%d each), launches %d kernels %d lost %d (past '
                          'the pad %d) %s, min gap %s us' % (
                              stage, d, trial, r['process_s'], r['flash'],
                              r['flash_want'], r['launches'], r['kernels'],
                              r['lost'], r['lost_step'], r['lost_at'],
                              r['min_gap_us']),
                          flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    summary = {d: {'traces': sum(r['discipline'] == d for r in rows),
                   'flash_ok': sum(r['discipline'] == d and r['flash_ok']
                                   for r in rows),
                   'lost': sum(r['lost'] for r in rows
                               if r['discipline'] == d),
                   'lost_step': sum(r['lost_step'] for r in rows
                                    if r['discipline'] == d)}
               for d in args.disciplines.split(',')}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, 'w') as fh:
            json.dump({'card': smi, 'rows': rows}, fh, indent=1)
    print(json.dumps({'card': smi, 'summary': summary,
                      'seconds': round(time.time() - t0, 1)}))


if __name__ == '__main__':
    main()
