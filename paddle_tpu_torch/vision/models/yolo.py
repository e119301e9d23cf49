"""The PP-YOLOv2-family detector (counterpart of
paddle_tpu/vision/models/yolo.py; BASELINE config 4): a CSP-style
residual backbone with three feature levels, a top-down neck, a YOLOv3
head a level, yolo_box decoding and matrix NMS with padded outputs.

It is the JAX package's scaled-down detector, not PaddleDetection's
PP-YOLOv2: no deformable convolutions, no SPP. Layers are built on
`device` (the current device when None) with weights drawn from a
generator seeded with `seed`; `load_vision_state` carries the JAX
model's state across.
"""
import torch
from torch import nn

from ... import nn as pnn
from ...nn import functional as F
from ...tensor import manipulation as M
from .. import detection as det
from .. import ops as vops
from ._utils import layer_kw

__all__ = ['PPYOLOv2', 'ppyolov2']


class ConvBNLayer(nn.Module):
    def __init__(self, cin, cout, k=3, stride=1, *, kw):
        super().__init__()
        self.conv = pnn.Conv2D(cin, cout, k, stride=stride, padding=k // 2,
                               bias_attr=False, **kw)
        self.bn = pnn.BatchNorm2D(cout, device=kw['device'])

    def forward(self, x):
        return F.mish(self.bn(self.conv(x)))


class CSPBlock(nn.Module):
    """A cross-stage-partial residual stage (CSPResNet flavour)."""

    def __init__(self, cin, cout, n=1, downsample=True, *, kw):
        super().__init__()
        self.down = ConvBNLayer(cin, cout, 3, stride=2 if downsample else 1,
                                kw=kw)
        self.split1 = ConvBNLayer(cout, cout // 2, 1, kw=kw)
        self.split2 = ConvBNLayer(cout, cout // 2, 1, kw=kw)
        self.blocks = pnn.LayerList([
            ConvBNLayer(cout // 2, cout // 2, 3, kw=kw) for _ in range(n)])
        self.merge = ConvBNLayer(cout, cout, 1, kw=kw)

    def forward(self, x):
        x = self.down(x)
        a = self.split1(x)
        b = self.split2(x)
        for blk in self.blocks:
            b = b + blk(b)
        return self.merge(M.concat([a, b], axis=1))


class YOLOHead(nn.Module):
    def __init__(self, cin, num_anchors, num_classes, *, kw):
        super().__init__()
        self.tip = ConvBNLayer(cin, cin * 2, 3, kw=kw)
        self.pred = pnn.Conv2D(cin * 2, num_anchors * (5 + num_classes), 1,
                               **kw)

    def forward(self, x):
        return self.pred(self.tip(x))


class PPYOLOv2(nn.Module):
    """The forward returns the per-level raw head maps in training mode,
    and the decoded (boxes [B, M, 4], scores [B, C, M]) ready for NMS in
    eval mode."""

    ANCHORS = [[10, 13, 16, 30, 33, 23],
               [30, 61, 62, 45, 59, 119],
               [116, 90, 156, 198, 373, 326]]
    DOWNSAMPLES = [8, 16, 32]

    def __init__(self, num_classes=80, width=32, img_size=320, *,
                 device=None, seed=0):
        super().__init__()
        kw = layer_kw(device, seed)
        self.num_classes = num_classes
        self.img_size = img_size
        w = width
        self.stem = ConvBNLayer(3, w, 3, kw=kw)
        self.c2 = CSPBlock(w, w * 2, n=1, kw=kw)        # /2
        self.c3 = CSPBlock(w * 2, w * 4, n=2, kw=kw)    # /4
        self.c4 = CSPBlock(w * 4, w * 8, n=2, kw=kw)    # /8  -> P3
        self.c5 = CSPBlock(w * 8, w * 16, n=2, kw=kw)   # /16 -> P4
        self.c6 = CSPBlock(w * 16, w * 16, n=1, kw=kw)  # /32 -> P5
        # the top-down neck (PAN-lite)
        self.lat5 = ConvBNLayer(w * 16, w * 8, 1, kw=kw)
        self.lat4 = ConvBNLayer(w * 16 + w * 8, w * 4, 1, kw=kw)
        self.lat3 = ConvBNLayer(w * 8 + w * 4, w * 2, 1, kw=kw)
        self.head3 = YOLOHead(w * 2, 3, num_classes, kw=kw)
        self.head4 = YOLOHead(w * 4, 3, num_classes, kw=kw)
        self.head5 = YOLOHead(w * 8, 3, num_classes, kw=kw)

    def backbone_neck(self, x):
        x = self.stem(x)
        x = self.c2(x)
        x = self.c3(x)
        p3 = self.c4(x)
        p4 = self.c5(p3)
        p5 = self.c6(p4)
        f5 = self.lat5(p5)
        up5 = F.interpolate(f5, scale_factor=2, mode='nearest')
        f4 = self.lat4(M.concat([p4, up5], axis=1))
        up4 = F.interpolate(f4, scale_factor=2, mode='nearest')
        f3 = self.lat3(M.concat([p3, up4], axis=1))
        return f3, f4, f5

    def forward(self, x):
        f3, f4, f5 = self.backbone_neck(x)
        outs = [self.head3(f3), self.head4(f4), self.head5(f5)]
        if self.training:
            return outs
        return self.decode(outs, x.shape[0])

    def decode(self, outs, batch):
        """yolo_box a level -> concatenated (boxes [B, M, 4], scores
        [B, C, M])."""
        img = torch.full((batch, 2), self.img_size, dtype=torch.int32,
                         device=outs[0].device)
        all_boxes, all_scores = [], []
        for out, anchors, ds in zip(outs, self.ANCHORS, self.DOWNSAMPLES):
            boxes, scores = vops.yolo_box(
                out, img, anchors=anchors, class_num=self.num_classes,
                conf_thresh=0.005, downsample_ratio=ds)
            all_boxes.append(boxes)                        # [B, m, 4]
            all_scores.append(scores.transpose(1, 2))      # [B, C, m]
        return torch.cat(all_boxes, dim=1), torch.cat(all_scores, dim=2)

    def postprocess(self, boxes, scores, score_threshold=0.01,
                    post_threshold=0.01, keep_top_k=100):
        """matrix_nms over the decoded boxes (the PP-YOLOv2
        configuration). Returns (out [B * K, 6] padded, rois_num [B])."""
        return det.matrix_nms(
            boxes, scores, score_threshold=score_threshold,
            post_threshold=post_threshold, nms_top_k=400,
            keep_top_k=keep_top_k, use_gaussian=True,
            background_label=-1)


def ppyolov2(num_classes=80, **kwargs):
    return PPYOLOv2(num_classes=num_classes, **kwargs)
