"""How far QAT's first gradient moves when the weights move by 1e-15, with
the stem's max pool and with an average pool in its place (CPU, float64).

    python3 qat_tie_probe.py [--batch 32] [--size 64]

resnet18 with seeded weights in float64 under slim.ImperativeQuantAware
(channel-wise weights, moving-average activations), one forward and
backward of cross-entropy on a seeded batch (chip_smoke's phase 30 (b)
float64 batch), then the same with every parameter scaled by 1 + 1e-15.
Prints, for each pooling, the loss of both, each parameter gradient's
largest change over its largest entry (the five worst), how many of
conv1.weight's gradient entries moved by more than 1e-10 of its largest,
and whether any quantized level or straight-through mask changed. Runs on
the CPU; no card needed.
"""
import argparse

import torch

import chip_smoke as cs
from paddle_tpu_torch.slim import ImperativeQuantAware
from paddle_tpu_torch.slim import quant_layers
from paddle_tpu_torch.vision.models import resnet18


def _first_step(base, x, y, perturb, pool):
    model = resnet18(device='cpu', seed=cs.SEED + 1).double()
    model.load_state_dict(base)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1 + perturb)
    ImperativeQuantAware(
        weight_quantize_type='channel_wise_abs_max').quantize(model)
    if pool == 'avg':
        model.maxpool = torch.nn.AvgPool2d(3, 2, 1)
    seen = []
    ste = quant_layers._ste_round_clip

    def record(v, qmax):
        out = ste(v, qmax)
        seen.append((v.detach().abs() <= qmax, out.detach()))
        return out
    quant_layers._ste_round_clip = record
    try:
        loss = torch.nn.functional.cross_entropy(model(x), y)
        loss.backward()
    finally:
        quant_layers._ste_round_clip = ste
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}, seen


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--batch', type=int, default=cs.RESNET_F32_BATCH)
    ap.add_argument('--size', type=int, default=cs.RESNET_F32_SIZE)
    args = ap.parse_args()
    base = resnet18(device='cpu', seed=cs.SEED).state_dict()
    x, y = cs._vision_batch(cs.SEED + 300, args.batch, args.size, 'cpu',
                            torch.float64)
    for pool in ('max', 'avg'):
        a = _first_step(base, x, y, 0.0, pool)
        b = _first_step(base, x, y, 1e-15, pool)
        rel = sorted((((b[1][k] - g).abs().max() / g.abs().max()).item(), k)
                     for k, g in a[1].items())[::-1]
        g = a[1]['conv1.weight']
        moved = int(((b[1]['conv1.weight'] - g).abs() >
                     1e-10 * g.abs().max()).sum())
        changed = sum(int((ma != mb).sum()) + int((la != lb).sum())
                      for (ma, la), (mb, lb) in zip(a[2], b[2]))
        print('%s pool: loss %.17g / %.17g; largest gradient moves %s; '
              'conv1.weight entries moved %d of %d; quantized levels or '
              'masks changed: %d' % (
                  pool, a[0], b[0], ', '.join('%s %.3g' % (k, v)
                                              for v, k in rel[:5]),
                  moved, g.numel(), changed), flush=True)


if __name__ == '__main__':
    main()
