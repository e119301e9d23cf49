"""yolo_box under torch.compile on the card, by head size and layout.

    python3 yolo_layout_probe.py

PP-YOLOv2's decode runs yolo_box on three heads (40 x 40, 20 x 20 and
10 x 10 at 320 x 320). Inside a compiled program Inductor may lay the head
convolutions' outputs out channels-last. For each head size, each layout
(contiguous, channels-last) and batch 8, this compiles two formulations
of the box arithmetic and holds each to its eager result:
- "stacked": the four coordinates as four [N, na, H, W] tensors stacked
  on a last axis (the port's yolo_box before slice 23);
- "port": paddle_tpu_torch.vision.ops.yolo_box (one [N, na, 4, H, W]
  tensor, permuted as the scores are).
Each line prints the boxes' and scores' largest error over the largest
value and the entries more than 1e-4 of it off. Exits 1 if the port's
formulation is off anywhere. Needs one card; imports no JAX.
"""
import sys
import time

import torch

ANCHORS = {40: [10, 13, 16, 30, 33, 23], 20: [30, 61, 62, 45, 59, 119],
           10: [116, 90, 156, 198, 373, 326]}
STRIDE = {40: 8, 20: 16, 10: 32}
BATCH, CLASSES, IMG = 8, 80, 320


def stacked(x, img_size, anchors, class_num, conf_thresh, downsample_ratio):
    """The stacked formulation (clip_bbox, scale_x_y 1)."""
    na = len(anchors) // 2
    anchors_arr = torch.tensor(anchors, dtype=torch.float32,
                               device=x.device).reshape(na, 2)
    n, c, h, w = x.shape
    a = x.reshape(n, na, -1, h, w)
    grid_x = torch.arange(w, dtype=torch.float32,
                          device=a.device).reshape(1, 1, 1, w)
    grid_y = torch.arange(h, dtype=torch.float32,
                          device=a.device).reshape(1, 1, h, 1)
    bx = (torch.sigmoid(a[:, :, 0]) + grid_x) / w
    by = (torch.sigmoid(a[:, :, 1]) + grid_y) / h
    bw = torch.exp(a[:, :, 2]) * anchors_arr[:, 0].reshape(1, na, 1, 1) / \
        (w * downsample_ratio)
    bh = torch.exp(a[:, :, 3]) * anchors_arr[:, 1].reshape(1, na, 1, 1) / \
        (h * downsample_ratio)
    conf = torch.sigmoid(a[:, :, 4])
    scores = conf[:, :, None] * torch.sigmoid(a[:, :, 5:5 + class_num])
    img_h = img_size[:, 0].reshape(n, 1, 1, 1).to(torch.float32)
    img_w = img_size[:, 1].reshape(n, 1, 1, 1).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=a.device)

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, zero), hi - 1)
    x0 = clip((bx - bw / 2) * img_w, img_w)
    y0 = clip((by - bh / 2) * img_h, img_h)
    x1 = clip((bx + bw / 2) * img_w, img_w)
    y1 = clip((by + bh / 2) * img_h, img_h)
    boxes = torch.stack([x0, y0, x1, y1], dim=-1).reshape(n, -1, 4)
    scores = scores.permute(0, 1, 3, 4, 2).reshape(n, -1, class_num)
    mask = (conf.reshape(n, -1, 1) > conf_thresh).to(boxes.dtype)
    return boxes * mask, scores * mask


def main():
    if not torch.cuda.is_available():
        print('yolo_layout_probe: CUDA is not available', file=sys.stderr)
        return 1
    from paddle_tpu_torch.vision import ops as vops

    print('card: %s, torch %s' % (torch.cuda.get_device_name(0),
                                  torch.__version__), flush=True)
    worst = 0.0
    for size in (10, 20, 40):
        for channels_last in (False, True):
            gen = torch.Generator(device='cuda').manual_seed(size)
            x = torch.randn(BATCH, 3 * (5 + CLASSES), size, size,
                            device='cuda', generator=gen)
            if channels_last:
                x = x.contiguous(memory_format=torch.channels_last)
            img = torch.full((BATCH, 2), IMG, dtype=torch.int32,
                             device='cuda')
            kw = dict(anchors=ANCHORS[size], class_num=CLASSES,
                      conf_thresh=0.005, downsample_ratio=STRIDE[size])
            for name, fn in (('stacked', stacked), ('port', vops.yolo_box)):
                with torch.no_grad():
                    want = fn(x, img, **kw)
                    torch._dynamo.reset()
                    t0 = time.time()
                    got = torch.compile(lambda a, b: fn(a, b, **kw),
                                        fullgraph=True, dynamic=False)(x, img)
                errs, wrong = [], 0
                for g, w in zip(got, want):
                    scale = w.abs().max()
                    errs.append(float((g - w).abs().max() / scale))
                    wrong += int(((g - w).abs() > 1e-4 * scale).sum())
                if name == 'port':
                    worst = max(worst, max(errs))
                print('%-7s head %2d x %2d, %-14s batch %d: boxes %.3g, '
                      'scores %.3g of the largest; %d entries off; compile '
                      '%.1f s' % (name, size, size, 'channels-last' if
                                  channels_last else 'contiguous', BATCH,
                                  errs[0], errs[1], wrong, time.time() - t0),
                      flush=True)
    return 0 if worst <= 1e-4 else 1


if __name__ == '__main__':
    sys.exit(main())
