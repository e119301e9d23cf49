"""vision.ops.yolo_box compiled for the card on a channels-last head.

Compiled with Inductor, the box formulation that stacked its four
coordinates on a last axis gave wrong boxes for a channels-last 10 x 10
head at batch 2 or more (the layout Inductor gives a compiled model's
head convolutions); the CPU is right either way. The port's yolo_box
must match its eager result there, and the stacked formulation of
yolo_layout_probe.py, held to the same check, must fail it: that is what
shows the check sees the fault. Imports no JAX, so it runs on a GPU
machine with
`python -m pytest --noconftest -m cuda tests/test_torch_yolo_box_cuda.py`.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import pytest
import torch

import yolo_layout_probe as probe
from paddle_tpu_torch.vision import ops as vops

BATCH, SIZE, TOL = 2, 10, 1e-4


def _compiled_vs_eager(fn):
    """The largest error of the compiled boxes and scores, each over its
    eager result's largest magnitude."""
    gen = torch.Generator(device='cuda').manual_seed(SIZE)
    x = torch.randn(BATCH, 3 * (5 + probe.CLASSES), SIZE, SIZE,
                    device='cuda', generator=gen).contiguous(
                        memory_format=torch.channels_last)
    img = torch.full((BATCH, 2), probe.IMG, dtype=torch.int32, device='cuda')
    kw = dict(anchors=probe.ANCHORS[SIZE], class_num=probe.CLASSES,
              conf_thresh=0.005, downsample_ratio=probe.STRIDE[SIZE])
    with torch.no_grad():
        want = fn(x, img, **kw)
        torch._dynamo.reset()
        got = torch.compile(lambda a, b: fn(a, b, **kw), fullgraph=True,
                            dynamic=False)(x, img)
    errs = []
    for g, w in zip(got, want):
        assert g.shape == w.shape
        errs.append(float((g - w).abs().max() / w.abs().max()))
    return errs


@pytest.mark.cuda
@pytest.mark.parametrize('formulation', ['port', 'stacked'])
def test_compiled_yolo_box_on_a_channels_last_head(formulation):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    if formulation == 'port':
        boxes, scores = _compiled_vs_eager(vops.yolo_box)
        assert boxes <= TOL and scores <= TOL, (boxes, scores)
    else:
        boxes, scores = _compiled_vs_eager(probe.stacked)
        assert boxes > TOL, (
            'the stacked formulation compiles right (boxes %.3g of the '
            'largest): this torch no longer shows the fault, so the port '
            "case no longer proves the repair" % boxes)
