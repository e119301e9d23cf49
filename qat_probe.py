"""Loss curves of ResNet-50 training under QAT beside the plain step on one
NVIDIA GPU.

    python3 qat_probe.py [--steps 24]

chip_smoke's phase 27 (a) recipe (resnet50 with seeded weights, batch 64
of seeded 3 x 224 x 224 images and labels, Momentum lr 0.1 through
TrainStep), plain and with every Conv2D / Linear wrapped by
slim.ImperativeQuantAware (channel-wise weights, moving-average
activations), on phase 27 (a)'s batch and on another, in bf16 and in
f32: one line of losses per run. It shows how the QAT loss moves over
more steps than phase 30 (b) times.
"""
import argparse
import sys
import time

import torch

import chip_smoke as cs
from paddle_tpu_torch.slim import ImperativeQuantAware
from paddle_tpu_torch.vision.models import resnet50


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--steps', type=int, default=24)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('qat_probe: CUDA is not available', file=sys.stderr)
        return 1
    print(cs._nvidia_smi(), flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        for off in (27, 30):
            for quant in (False, True):
                t = time.time()
                x, y = cs._vision_batch(cs.SEED + off, cs.VISION_BATCH,
                                        cs.VISION_SIZE, 'cuda', dtype)
                model = resnet50(device='cuda', seed=cs.SEED).to(dtype)
                if quant:
                    ImperativeQuantAware(
                        weight_quantize_type='channel_wise_abs_max'
                    ).quantize(model)
                step = cs._vision_step(model, cs.VISION_LR)
                losses = [step(x, y).item() for _ in range(args.steps)]
                print('%s batch SEED+%d %s: %s (%.1f s)' % (
                    str(dtype).split('.')[-1], off,
                    'QAT' if quant else 'plain',
                    ' '.join('%.3f' % v for v in losses), time.time() - t),
                    flush=True)
                del model, step
                torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
