"""Time chip_smoke's phases 19 and 20 (compiled mode, the inference
engine, the static graph) at the compiled GPT depths given, on the card.

    python3 compiled_depth_probe.py 3 1 1 3

Builds the flash kernels once, then runs each depth in a process of its
own with a fresh Inductor cache, in the order given (alternate them: the
host's speed drifts): phase 6 for the numbers phase 19 prints beside its
own, then phases 19 and 20 with chip_smoke.COMPILED_GPT2_LAYERS set to
the depth. Prints one line a run: the depth and each phase's seconds.
Exits non-zero without CUDA or when a run fails.
"""
import os
import subprocess
import sys
import tempfile
import time


def run(layers):
    import torch
    import chip_smoke as cs
    cs.COMPILED_GPT2_LAYERS = layers
    sku = cs._sku(torch.cuda.get_device_name(0))
    train = cs.train_main_phase(sku)
    t = time.time()
    cs.slice10_phases(sku, train)
    t19 = time.time() - t
    t = time.time()
    cs.slice11_phases()
    t20 = time.time() - t
    print('compiled_depth_probe: layers=%d phase19 %.1f s phase20 %.1f s '
          'sum %.1f s' % (layers, t19, t20, t19 + t20), flush=True)


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print('compiled_depth_probe: CUDA is not available', file=sys.stderr)
        return 1
    if len(argv) == 2 and argv[0] == '--run':
        run(int(argv[1]))
        return 0
    from paddle_tpu_torch import _build
    _build.build(['flash_fwd', 'flash_bwd'])
    here = os.path.dirname(os.path.abspath(__file__))
    for layers in argv or ['3', '1', '1', '3']:
        with tempfile.TemporaryDirectory(prefix='inductor_') as cache:
            env = dict(os.environ, TORCHINDUCTOR_CACHE_DIR=cache,
                       PYTHONPATH=here)
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), '--run', layers],
                cwd=here, env=env, capture_output=True, text=True,
                timeout=1800)
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith('compiled_depth_probe:')]
        if out.returncode or not lines:
            sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
            return out.returncode or 1
        print(lines[-1], flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
