"""Time the compiles of chip_smoke's phase 29 (c) and (d) on the card, and
of their parts.

    python3 yolo_compile_probe.py [variant ...]

Variants (all by default): `predictor` (PP-YOLOv2's eval forward at batch
1 x 320 through jit.StaticFunction, as the Predictor compiles it),
`tail` (phase 29 (d)'s fluid program: yolo_box -> transpose2 ->
multiclass_nms3), `yolo_box` (its yolo_box and transpose2 alone), `nms`
(its multiclass_nms3 alone, on the boxes and scores yolo_box gives) and
`matrix_nms` (PP-YOLOv2's postprocess at batch 8). Each runs in a process
of its own with a fresh Inductor cache, after a one-kernel warm-up
compile (the compile workers' start), and prints one line: the first
call's seconds, the kernels Inductor generated, and TorchDynamo's and
Inductor's own compile-time table. Exits non-zero without CUDA or when a
run fails.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

VARIANTS = ('predictor', 'tail', 'yolo_box', 'nms', 'matrix_nms')


def _fluid(variant, root):
    """phase 29 (d)'s program, or the part of it the variant names, and
    its feeds."""
    import numpy as np
    import chip_smoke as cs
    from paddle_tpu_torch.inference import fluid_program
    from paddle_tpu_torch.vision import ops

    na, cls, h, batch = 3, 80, 10, 8
    c, m = na * (5 + cls), na * h * h
    gen = np.random.RandomState(cs.SEED + 294)
    head = gen.randn(batch, c, h, h).astype(np.float32)
    imgsz = np.full((batch, 2), 320, np.int32)
    yolo = cs._pb_op('yolo_box', {'X': ['head'], 'ImgSize': ['imgsz']},
                     {'Boxes': ['boxes'], 'Scores': ['scores_mc']},
                     anchors=[116, 90, 156, 198, 373, 326], class_num=cls,
                     conf_thresh=0.01, downsample_ratio=32, clip_bbox=True,
                     scale_x_y=1.05)
    trans = cs._pb_op('transpose2', {'X': ['scores_mc']},
                      {'Out': ['scores']}, axis=[0, 2, 1])
    nms = cs._pb_op('multiclass_nms3', {'BBoxes': ['boxes'],
                                        'Scores': ['scores']},
                    {'Out': ['dets'], 'NmsRoisNum': ['rois_n']},
                    **cs.YOLO_TAIL_NMS)
    variables = [cs._pb_var('head', dims=[-1, c, h, h]),
                 cs._pb_var('imgsz', dims=[-1, 2], dtype=2),
                 cs._pb_var('boxes', dims=[-1, m, 4]),
                 cs._pb_var('scores_mc', dims=[-1, m, cls]),
                 cs._pb_var('scores', dims=[-1, cls, m]),
                 cs._pb_var('dets', dims=[-1, 6]),
                 cs._pb_var('rois_n', dims=[-1], dtype=2)]
    if variant == 'tail':
        feeds, fetches, op_list = ['head', 'imgsz'], ['dets', 'rois_n'], \
            [yolo, trans, nms]
        feed = {'head': head, 'imgsz': imgsz}
    elif variant == 'yolo_box':
        feeds, fetches, op_list = ['head', 'imgsz'], ['boxes', 'scores'], \
            [yolo, trans]
        feed = {'head': head, 'imgsz': imgsz}
    else:
        import torch
        boxes, scores = ops.yolo_box(
            torch.from_numpy(head), torch.from_numpy(imgsz),
            anchors=[116, 90, 156, 198, 373, 326], class_num=cls,
            conf_thresh=0.01, downsample_ratio=32, scale_x_y=1.05)
        feeds, fetches, op_list = ['boxes', 'scores'], ['dets', 'rois_n'], \
            [nms]
        feed = {'boxes': boxes.numpy(),
                'scores': scores.transpose(1, 2).contiguous().numpy()}
    model, _ = cs._write_fluid(root, variant, feeds, fetches, variables,
                               op_list, {}, False)
    prog = fluid_program.load_fluid_model(model, device='cuda')
    return lambda: prog.run(feed)


def _target(variant, root):
    import torch
    import chip_smoke as cs
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.vision.models import ppyolov2

    if variant in ('predictor', 'matrix_nms'):
        model = ppyolov2(**cs.YOLO_CFG, device='cuda', seed=cs.SEED).eval()
        batch = 1 if variant == 'predictor' else 8
        x = torch.rand(batch, 3, 320, 320, device='cuda')
        if variant == 'predictor':
            fn = jit.StaticFunction(model.forward, layer=model)
            return lambda: fn(x)
        with torch.no_grad():
            boxes, scores = model(x)
        fn = jit.StaticFunction(model.postprocess)
        return lambda: fn(boxes, scores)
    return _fluid(variant, root)


def run(variant):
    import torch
    import torch._dynamo.utils as dutils
    import torch._inductor.metrics as imetrics
    from paddle_tpu_torch import jit

    torch.backends.cudnn.allow_tf32 = False
    warm = jit.StaticFunction(lambda a: a * 2 + 1)
    warm(torch.ones(4, device='cuda'))
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as root:
        call = _target(variant, root)
        before = imetrics.generated_kernel_count
        t0 = time.perf_counter()
        with torch.no_grad():
            call()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    print('yolo_compile_probe: %s' % json.dumps({
        'variant': variant, 'first_call_s': round(seconds, 2),
        'kernels': imetrics.generated_kernel_count - before,
        'compile_threads': torch._inductor.config.compile_threads}),
        flush=True)
    print(dutils.compile_times(), flush=True)


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print('yolo_compile_probe: CUDA is not available', file=sys.stderr)
        return 1
    variants = argv or list(VARIANTS)
    for v in variants:
        if v not in VARIANTS:
            print('unknown variant %r (%s)' % (v, ', '.join(VARIANTS)),
                  file=sys.stderr)
            return 2
    here = os.path.dirname(os.path.abspath(__file__))
    for v in variants:
        with tempfile.TemporaryDirectory() as cache:
            env = dict(os.environ, TORCHINDUCTOR_CACHE_DIR=cache,
                       PYTHONPATH=here)
            res = subprocess.run(
                [sys.executable, '-c', 'import yolo_compile_probe as p; '
                 'p.run(%r)' % v], cwd=here, env=env, timeout=900)
        if res.returncode:
            return res.returncode
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
