"""Vision ops (counterpart of paddle_tpu/vision/ops.py; reference:
python/paddle/vision/ops.py — yolo_box, yolo_loss, nms, roi_align,
deform_conv, distribute_fpn_proposals...).

The device ops (yolo_box, yolo_loss, roi_align, box_coder,
deform_conv2d) are torch ops on the input's device, in the JAX package's
arithmetic; yolo_loss's gradient is autograd through it. The ops whose
output size depends on the data (nms, generate_proposals,
distribute_fpn_proposals) and the shape-only prior_box run in numpy on
the host with the JAX package's calls, so that numpy's unstable argsort
breaks ties the same way; their outputs are tensors on the device of the
input they were given.

Behaviours kept from the JAX package: roi_pool is roi_align with
aligned=False (an average, not a max); PSRoIPool is RoIAlign (not
position-sensitive); roi_align takes a fixed s x s grid a bin, one
sample when sampling_ratio <= 0, and weighs each sample by its clipped
corners (so samples past the map extrapolate).

deform_conv2d is Paddle's deformable convolution v1 / v2
(operators/deformable_conv_op), the function the JAX package's body and
docstring describe: that function raises on every input (a 5-d gather
broadcast against a 6-d weight), so the port does not copy it.
"""
import io as _io

import numpy as np
import torch
import torch.nn.functional as tF

from ..amp.auto_cast import cast as amp_cast
from ..framework import device as device_mod

__all__ = ['read_file', 'decode_jpeg',
           'yolo_box', 'yolo_loss', 'nms', 'roi_align', 'roi_pool',
           'box_coder', 'prior_box', 'deform_conv2d', 'DeformConv2D',
           'distribute_fpn_proposals', 'generate_proposals', 'PSRoIPool',
           'RoIAlign', 'RoIPool']


def _host(t):
    """A tensor's values as a numpy array on the host."""
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _device_of(t):
    return t.device if isinstance(t, torch.Tensor) else device_mod.resolve()


def _on(a, device):
    return torch.from_numpy(np.array(a)).to(device)


def _max0(v):
    """max(v, 0) with jnp.maximum's gradient: half to each side at a
    tie (clamp passes all of it)."""
    return torch.maximum(v, torch.zeros((), dtype=v.dtype, device=v.device))


def _clip(v, lo, hi):
    """jnp.clip (a minimum of a maximum) with its gradient at the ends."""
    def c(a):
        return torch.tensor(a, dtype=v.dtype, device=v.device)
    return torch.minimum(torch.maximum(v, c(lo)), c(hi))


def yolo_box(x, img_size, anchors, class_num, conf_thresh, downsample_ratio,
             clip_bbox=True, name=None, scale_x_y=1.0, iou_aware=False,
             iou_aware_factor=0.5):
    """Decode a YOLOv3 head's output to boxes and scores
    (operators/detection/yolo_box_op): boxes [N, na * H * W, 4] and scores
    [N, na * H * W, class_num], both zero where the confidence is at or
    below conf_thresh.

    The four box coordinates are computed as one [N, na, 4, H, W] tensor
    and laid out as the scores are (permute, then reshape): compiled for
    the card with torch 2.11, stacking four [N, na, H, W] coordinates on
    a last axis gave wrong boxes for a channels-last 10 x 10 head at N >=
    2 (Inductor's layout optimisation makes the head convolutions' outputs
    channels-last), while this layout gives the eager values."""
    a, = amp_cast('yolo_box', x)
    na = len(anchors) // 2
    dev = a.device
    anchors_arr = torch.tensor(anchors, dtype=torch.float32,
                               device=dev).reshape(1, na, 2, 1, 1)
    n, c, h, w = a.shape
    ioup = None
    if iou_aware:
        # the iou_aware layout: the first `na` channels are the anchors'
        # IoU predictions, the rest is the standard head
        ioup = torch.sigmoid(a[:, :na].reshape(n, na, h, w))
        a = a[:, na:]
    a = a.reshape(n, na, -1, h, w)
    grid_x = torch.arange(w, dtype=torch.float32, device=dev)
    grid_y = torch.arange(h, dtype=torch.float32, device=dev)
    grid = torch.stack([grid_x.reshape(1, w).expand(h, w),
                        grid_y.reshape(h, 1).expand(h, w)]).reshape(
        1, 1, 2, h, w)
    size = torch.tensor([w, h], dtype=torch.float32,
                        device=dev).reshape(1, 1, 2, 1, 1)
    # centres (x, y) and sizes (w, h) as fractions of the image
    xy = (torch.sigmoid(a[:, :, 0:2]) * scale_x_y - 0.5 * (scale_x_y - 1.0) +
          grid) / size
    wh = torch.exp(a[:, :, 2:4]) * anchors_arr / (size * downsample_ratio)
    conf = torch.sigmoid(a[:, :, 4])
    if ioup is not None:
        # PP-YOLO's IoU-aware confidence: obj^(1-f) * iou^f
        conf = conf ** (1.0 - iou_aware_factor) * ioup ** iou_aware_factor
    probs = torch.sigmoid(a[:, :, 5:5 + class_num])
    scores = conf[:, :, None] * probs
    # img_size rows are (h, w): (w, h) to scale (x, y)
    img_wh = img_size.to(dev)[:, [1, 0]].to(torch.float32).reshape(
        n, 1, 2, 1, 1)
    lo = (xy - wh / 2) * img_wh
    hi = (xy + wh / 2) * img_wh
    if clip_bbox:
        zero = torch.zeros((), dtype=lo.dtype, device=dev)
        lo = torch.minimum(torch.maximum(lo, zero), img_wh - 1)
        hi = torch.minimum(torch.maximum(hi, zero), img_wh - 1)
    boxes = torch.cat([lo, hi], dim=2).permute(0, 1, 3, 4, 2).reshape(
        n, -1, 4)
    scores = scores.permute(0, 1, 3, 4, 2).reshape(n, -1, class_num)
    mask = (conf.reshape(n, -1, 1) > conf_thresh).to(boxes.dtype)
    return boxes * mask, scores * mask


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """The YOLOv3 loss (operators/detection/yolov3_loss_op), a [N] tensor
    each entry of which is the batch's total over N."""
    a, = amp_cast('yolo_loss', x)
    dev = a.device
    gtb = gt_box.to(dev)
    gtl = gt_label.to(dev)
    na = len(anchor_mask)
    anchors_full = torch.tensor(anchors, dtype=torch.float32,
                                device=dev).reshape(-1, 2)
    mask_idx = torch.tensor(anchor_mask, device=dev)
    mask_anchors = anchors_full[mask_idx]
    n, c, h, w = a.shape
    a = a.reshape(n, na, 5 + class_num, h, w)
    input_size = h * downsample_ratio
    # targets: each ground-truth box's responsible anchor and cell
    bx = gtb[..., 0] * w
    by = gtb[..., 1] * h
    gw = gtb[..., 2] * input_size
    gh = gtb[..., 3] * input_size
    # the cast truncates toward zero, as astype(int32) does
    gi = bx.to(torch.int32).clamp(0, w - 1)
    gj = by.to(torch.int32).clamp(0, h - 1)
    # the anchors' IoU on width and height
    inter = torch.minimum(gw[..., None], anchors_full[:, 0]) * \
        torch.minimum(gh[..., None], anchors_full[:, 1])
    union = gw[..., None] * gh[..., None] + \
        anchors_full[:, 0] * anchors_full[:, 1] - inter
    best = torch.argmax(inter / union.clamp(min=1e-9), dim=-1)
    valid = gtb[..., 2] > 0
    hit = best[..., None] == mask_idx
    in_mask = hit.any(-1) & valid
    local_a = torch.argmax(hit.to(torch.int32), dim=-1)

    bidx = torch.arange(n, device=dev)[:, None] * torch.ones_like(gi)
    sel = (bidx, local_a, gj.long(), gi.long())
    tx = bx - torch.floor(bx)
    ty = by - torch.floor(by)
    tw = torch.log((gw / mask_anchors[local_a, 0].clamp(min=1e-9))
                   .clamp(min=1e-9))
    th = torch.log((gh / mask_anchors[local_a, 1].clamp(min=1e-9))
                   .clamp(min=1e-9))
    scale = 2.0 - gtb[..., 2] * gtb[..., 3]

    # scale_x_y (PP-YOLO): stretch the sigmoid box centre
    px = torch.sigmoid(a[:, :, 0]) * scale_x_y - 0.5 * (scale_x_y - 1.0)
    py = torch.sigmoid(a[:, :, 1]) * scale_x_y - 0.5 * (scale_x_y - 1.0)
    pw = a[:, :, 2]
    ph = a[:, :, 3]
    pobj = a[:, :, 4]
    pcls = a[:, :, 5:]

    m = in_mask.to(a.dtype)
    if gt_score is not None:
        # mixup / soft scores weigh every positive term (the reference's
        # GTScore input)
        m = m * gt_score.to(dev, a.dtype)
    loss_xy = torch.sum(m * scale * ((px[sel] - tx) ** 2 +
                                     (py[sel] - ty) ** 2))
    loss_wh = torch.sum(m * scale * ((pw[sel] - tw) ** 2 +
                                     (ph[sel] - th) ** 2))
    # a scatter-max: two boxes on one anchor and cell give the larger
    # weight, not the sum or the last write
    cell = ((bidx * na + local_a) * h + gj.long()) * w + gi.long()
    obj_target = torch.zeros(n * na * h * w, dtype=a.dtype,
                             device=dev).scatter_reduce(
        0, cell.reshape(-1), m.reshape(-1), 'amax',
        include_self=True).reshape(n, na, h, w)
    # ignore_thresh (yolov3_loss_op.h CalcObjnessLoss): negatives whose
    # predicted box overlaps any ground truth above the threshold leave
    # the objectness loss
    grid_x = torch.arange(w, dtype=a.dtype, device=dev)[None, None, None, :]
    grid_y = torch.arange(h, dtype=a.dtype, device=dev)[None, None, :, None]
    pbx = (grid_x + px) / w                                   # [n,na,h,w]
    pby = (grid_y + py) / h
    pbw = torch.exp(_clip(pw, -10.0, 10.0)) * \
        mask_anchors[:, 0][None, :, None, None] / input_size
    pbh = torch.exp(_clip(ph, -10.0, 10.0)) * \
        mask_anchors[:, 1][None, :, None, None] / input_size
    # corners in normalized coordinates; ground truths are (cx, cy, w, h)
    p_x0, p_x1 = pbx - pbw / 2, pbx + pbw / 2
    p_y0, p_y1 = pby - pbh / 2, pby + pbh / 2
    g_x0 = gtb[..., 0] - gtb[..., 2] / 2                      # [n, G]
    g_x1 = gtb[..., 0] + gtb[..., 2] / 2
    g_y0 = gtb[..., 1] - gtb[..., 3] / 2
    g_y1 = gtb[..., 1] + gtb[..., 3] / 2
    ex = (slice(None), None, None, None)  # ground truths over na, h, w
    iw = (torch.minimum(p_x1[..., None], g_x1[ex]) -
          torch.maximum(p_x0[..., None], g_x0[ex])).clamp(min=0.0)
    ih = (torch.minimum(p_y1[..., None], g_y1[ex]) -
          torch.maximum(p_y0[..., None], g_y0[ex])).clamp(min=0.0)
    inter_pg = iw * ih
    area_p = (pbw * pbh)[..., None]
    area_g = (gtb[..., 2] * gtb[..., 3])[ex]
    iou_pg = inter_pg / (area_p + area_g - inter_pg).clamp(min=1e-9)
    iou_pg = torch.where(valid[ex], iou_pg, 0.0)
    best_iou = iou_pg.amax(-1)                                # [n,na,h,w]
    noobj_keep = (best_iou <= ignore_thresh).to(a.dtype)
    obj_weight = obj_target + (1.0 - obj_target.clamp(max=1.0)) * noobj_keep
    bce = _max0(pobj) - pobj * obj_target + \
        torch.log1p(torch.exp(-pobj.abs()))
    loss_obj = torch.sum(bce * obj_weight)
    smooth = 1.0 / class_num if use_label_smooth else 0.0
    # one_hot as jax.nn.one_hot makes it: a label out of range is all 0
    cls_target = (gtl[..., None] == torch.arange(class_num, device=dev)) \
        .to(a.dtype)
    cls_target = cls_target * (1 - smooth) + smooth / 2
    pc = pcls.permute(0, 1, 3, 4, 2)[sel]
    bce_c = _max0(pc) - pc * cls_target + \
        torch.log1p(torch.exp(-pc.abs()))
    loss_cls = torch.sum(m[..., None] * bce_c)
    return (loss_xy + loss_wh + loss_obj + loss_cls) * \
        torch.ones((n,), dtype=a.dtype, device=dev) / n


def _iou_matrix(boxes, offset=0.0):
    # offset=1 reproduces the reference's legacy pixel-inclusive overlap
    # (JaccardOverlap with normalized=false)
    x0, y0, x1, y1 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = (x1 - x0 + offset) * (y1 - y0 + offset)
    ix0 = np.maximum(x0[:, None], x0[None, :])
    iy0 = np.maximum(y0[:, None], y0[None, :])
    ix1 = np.minimum(x1[:, None], x1[None, :])
    iy1 = np.minimum(y1[:, None], y1[None, :])
    iw = np.maximum(ix1 - ix0 + offset, 0)
    ih = np.maximum(iy1 - iy0 + offset, 0)
    inter = iw * ih
    return inter / np.maximum(area[:, None] + area[None, :] - inter, 1e-9)


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """Host NMS (operators/detection/nms_op; its output size depends on
    the data): the kept boxes' indices, int64, on the boxes' device."""
    if categories is not None and category_idxs is None:
        raise ValueError('nms: `categories` requires `category_idxs` '
                         '(per-box class ids)')
    b = _host(boxes)
    s = _host(scores) if scores is not None else None
    order = np.argsort(-s) if s is not None else np.arange(len(b))
    if category_idxs is not None:
        cats = _host(category_idxs)
    else:
        cats = np.zeros(len(b), dtype=np.int64)
    iou = _iou_matrix(b)
    keep = []
    suppressed = np.zeros(len(b), dtype=bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        over = (iou[i] > iou_threshold) & (cats == cats[i])
        suppressed |= over
        suppressed[i] = True
    keep = np.asarray(keep, dtype=np.int64)
    if categories is not None:
        # `categories` lists the class ids eligible for output
        keep = keep[np.isin(cats[keep], np.asarray(categories))]
    if top_k is not None:
        keep = keep[:top_k]
    return _on(keep, _device_of(boxes))


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """RoIAlign by bilinear sampling (operators/roi_align_op): x [N, C,
    H, W], boxes [R, 4] (x1, y1, x2, y2), boxes_num [N] -> [R, C, ph, pw].

    sampling_ratio s > 0 averages an s x s grid of samples a bin; <= 0
    takes one centred sample (the reference's adaptive ceil(roi / bin)
    count depends on the data; the fixed grid biases only very large
    rois)."""
    feat, = amp_cast('roi_align', x)
    dev = feat.device
    rois = boxes.to(dev)
    nums = boxes_num.to(dev)
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    ph, pw = output_size
    n, c, h, w = feat.shape
    R = rois.shape[0]
    batch_idx = torch.repeat_interleave(
        torch.arange(nums.shape[0], device=dev), nums.long(), output_size=R)
    offset = 0.5 if aligned else 0.0
    x0 = rois[:, 0] * spatial_scale - offset
    y0 = rois[:, 1] * spatial_scale - offset
    x1 = rois[:, 2] * spatial_scale - offset
    y1 = rois[:, 3] * spatial_scale - offset
    rw = (x1 - x0).clamp(min=1e-3)
    rh = (y1 - y0).clamp(min=1e-3)
    s = max(1, int(sampling_ratio)) if sampling_ratio and \
        sampling_ratio > 0 else 1
    f32 = torch.float32
    grid_h = (torch.arange(ph, device=dev)[:, None] +
              (torch.arange(s, device=dev) + 0.5)[None, :] / s
              ).reshape(-1) / ph
    grid_w = (torch.arange(pw, device=dev)[:, None] +
              (torch.arange(s, device=dev) + 0.5)[None, :] / s
              ).reshape(-1) / pw
    ys = y0[:, None] + grid_h.to(f32)[None, :] * rh[:, None]  # [R, ph*s]
    xs = x0[:, None] + grid_w.to(f32)[None, :] * rw[:, None]  # [R, pw*s]
    # every (y, x) pair of a roi, y major: [R, ph*s * pw*s]
    yy = ys.repeat_interleave(pw * s, dim=1)
    xx = xs.repeat(1, ph * s)
    y0i = torch.floor(yy).to(torch.int32).clamp(0, h - 1)
    x0i = torch.floor(xx).to(torch.int32).clamp(0, w - 1)
    y1i = (y0i + 1).clamp(0, h - 1)
    x1i = (x0i + 1).clamp(0, w - 1)
    # the weights come from the clipped corners: samples past the map
    # extrapolate
    wy = (yy - y0i)[:, None]
    wx = (xx - x0i)[:, None]
    flat = feat.reshape(n, c, h * w)

    def gather(yi, xi):
        idx = (yi * w + xi).long()                      # [R, P]
        return flat[batch_idx[:, None], :, idx].transpose(1, 2)  # [R, C, P]
    vals = (gather(y0i, x0i) * (1 - wy) * (1 - wx) +
            gather(y0i, x1i) * (1 - wy) * wx +
            gather(y1i, x0i) * wy * (1 - wx) +
            gather(y1i, x1i) * wy * wx)
    return vals.reshape(R, c, ph, s, pw, s).mean(dim=(3, 5))


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0, name=None):
    """roi_align with aligned=False, as the JAX package computes it (an
    average, not a max)."""
    return roi_align(x, boxes, boxes_num, output_size, spatial_scale,
                     aligned=False)


class RoIAlign:
    def __init__(self, output_size, spatial_scale=1.0):
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def __call__(self, x, boxes, boxes_num, aligned=True):
        return roi_align(x, boxes, boxes_num, self.output_size,
                         self.spatial_scale, aligned=aligned)


class RoIPool(RoIAlign):
    def __call__(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self.output_size,
                        self.spatial_scale)


class PSRoIPool(RoIAlign):
    """RoIAlign, as the JAX package's (not position-sensitive)."""


def box_coder(prior_box, prior_box_var, target_box,
              code_type='encode_center_size', box_normalized=True, axis=0,
              name=None):
    """Encode target boxes against priors, or decode offsets to boxes
    (operators/detection/box_coder_op)."""
    t, = amp_cast('box_coder', target_box)
    dev = t.device
    pb = prior_box.to(dev)
    pbv = torch.tensor(prior_box_var, dtype=torch.float32, device=dev) \
        if isinstance(prior_box_var, (list, tuple)) else prior_box_var.to(dev)
    norm = 0.0 if box_normalized else 1.0
    pw = pb[:, 2] - pb[:, 0] + norm
    ph_ = pb[:, 3] - pb[:, 1] + norm
    pcx = (pb[:, 0] + pb[:, 2]) / 2
    pcy = (pb[:, 1] + pb[:, 3]) / 2
    if code_type == 'encode_center_size':
        # every target row encodes against every prior -> [N, M, 4] (the
        # M priors ride dim 1)
        tw = (t[:, 2] - t[:, 0] + norm)[:, None]
        th = (t[:, 3] - t[:, 1] + norm)[:, None]
        tcx = ((t[:, 0] + t[:, 2]) / 2)[:, None]
        tcy = ((t[:, 1] + t[:, 3]) / 2)[:, None]
        pbv_e = pbv if pbv.dim() == 2 else pbv[None]
        ox = (tcx - pcx[None]) / pw[None] / pbv_e[..., 0]
        oy = (tcy - pcy[None]) / ph_[None] / pbv_e[..., 1]
        ow = torch.log(tw / pw[None]) / pbv_e[..., 2]
        oh = torch.log(th / ph_[None]) / pbv_e[..., 3]
        return torch.stack([ox, oy, ow, oh], dim=-1)
    # decode: `axis` names the dim of an [N, M, 4] target the priors
    # broadcast along: axis=0 -> priors [M, 4] ride dim 1; axis=1 ->
    # priors ride dim 0
    if t.dim() == 3:
        ex = (None, slice(None)) if axis == 0 else (slice(None), None)
        pw_b, ph_b, pcx_b, pcy_b = pw[ex], ph_[ex], pcx[ex], pcy[ex]
        pbv_b = pbv[ex + (slice(None),)] if pbv.dim() == 2 else pbv
    else:
        pw_b, ph_b, pcx_b, pcy_b, pbv_b = pw, ph_, pcx, pcy, pbv
    ox = t[..., 0] * pbv_b[..., 0] * pw_b + pcx_b
    oy = t[..., 1] * pbv_b[..., 1] * ph_b + pcy_b
    ow = torch.exp(t[..., 2] * pbv_b[..., 2]) * pw_b
    oh = torch.exp(t[..., 3] * pbv_b[..., 3]) * ph_b
    return torch.stack([ox - ow / 2, oy - oh / 2,
                        ox + ow / 2 - norm, oy + oh / 2 - norm], dim=-1)


@torch.compiler.assume_constant_result
def _prior_boxes(h, w, ih, iw, min_sizes, max_sizes, aspect_ratios,
                 variance, flip, clip, steps, offset,
                 min_max_aspect_ratios_order):
    """prior_box's boxes and variances from the shapes alone, in numpy as
    the JAX package computes them (a constant to a compiled program)."""
    step_h = steps[1] or ih / h
    step_w = steps[0] or iw / w
    ars = [1.0]
    for ar in aspect_ratios:
        if ar != 1.0:
            ars.append(ar)
            if flip:
                ars.append(1.0 / ar)
    boxes = []
    for ms_i, ms in enumerate(min_sizes):
        sizes = []
        for ar in ars:
            sizes.append((ms * np.sqrt(ar), ms / np.sqrt(ar)))
        if max_sizes:
            mx = max_sizes[ms_i]
            # the reference's order: [min & ars..., max] by default; the
            # min_max_aspect_ratios_order flag moves max right after the
            # ar = 1 min box (Caffe's order)
            if min_max_aspect_ratios_order:
                sizes.insert(1, (np.sqrt(ms * mx), np.sqrt(ms * mx)))
            else:
                sizes.append((np.sqrt(ms * mx), np.sqrt(ms * mx)))
        for (bw, bh) in sizes:
            cy, cx = np.mgrid[0:h, 0:w].astype(np.float32)
            cx = (cx + offset) * step_w
            cy = (cy + offset) * step_h
            boxes.append(np.stack([(cx - bw / 2) / iw, (cy - bh / 2) / ih,
                                   (cx + bw / 2) / iw, (cy + bh / 2) / ih],
                                  axis=-1))
    out = np.stack(boxes, axis=2)  # H, W, num_priors, 4
    if clip:
        out = np.clip(out, 0, 1)
    var = np.broadcast_to(np.asarray(variance, np.float32), out.shape)
    return (torch.from_numpy(out.astype(np.float32)),
            torch.from_numpy(var.copy()))


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0., 0.), offset=0.5, min_max_aspect_ratios_order=False,
              name=None):
    """SSD prior boxes for a feature map over an image (prior_box_op):
    (boxes [H, W, P, 4], variances [H, W, P, 4]) on the map's device."""
    boxes, var = _prior_boxes(
        int(input.shape[2]), int(input.shape[3]), int(image.shape[2]),
        int(image.shape[3]), tuple(min_sizes),
        tuple(max_sizes) if max_sizes else None, tuple(aspect_ratios),
        tuple(variance), flip, clip, tuple(steps), offset,
        min_max_aspect_ratios_order)
    return boxes.to(input.device), var.to(input.device)


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution v1 / v2 (operators/deformable_conv_op).

    The input is zero-padded; kernel point k of output (oy, ox) samples
    it at (oy * stride + ky * dilation, ox * stride + kx * dilation) plus
    its offset, laid out as offset [n, dg * kh * kw * 2 (y, x), oh, ow];
    the sample is bilinear over its four corners, a corner counting only
    inside the padded map; v2 multiplies it by mask [n, dg * kh * kw, oh,
    ow]. Deformable group g's offsets move input channels g * cin / dg
    to (g + 1) * cin / dg. Then a grouped product with the weight [cout,
    cin / groups, kh, kw], plus the bias."""
    args = amp_cast('deform_conv2d', x, offset, weight,
                    *([bias] if bias is not None else []),
                    *([mask] if mask is not None else []))
    a, off, wgt = args[:3]
    b = args[3] if bias is not None else None
    msk = args[-1] if mask is not None else None

    def pair(v):
        return (v, v) if isinstance(v, int) else tuple(v)
    sh, sw = pair(stride)
    ph_, pw_ = pair(padding)
    dh, dw = pair(dilation)
    dg = deformable_groups
    n, cin, h, wdt = a.shape
    cout, cin_g, kh, kw = wgt.shape
    K = kh * kw
    oh = (h + 2 * ph_ - dh * (kh - 1) - 1) // sh + 1
    ow = (wdt + 2 * pw_ - dw * (kw - 1) - 1) // sw + 1
    a_p = tF.pad(a, (pw_, pw_, ph_, ph_))
    hp, wp = a_p.shape[2], a_p.shape[3]
    dev, dt = a.device, a.dtype
    base_y = (torch.arange(oh, device=dev) * sh)[:, None, None, None] + \
        (torch.arange(kh, device=dev) * dh)[None, None, :, None]
    base_x = (torch.arange(ow, device=dev) * sw)[None, :, None, None] + \
        (torch.arange(kw, device=dev) * dw)[None, None, None, :]
    # [oh, ow, K], kernel points y major
    base_y = base_y.expand(oh, ow, kh, kw).reshape(oh, ow, K).to(dt)
    base_x = base_x.expand(oh, ow, kh, kw).reshape(oh, ow, K).to(dt)
    o = off.reshape(n, dg, K, 2, oh, ow)
    yy = base_y + o[:, :, :, 0].permute(0, 1, 3, 4, 2)   # [n, dg, oh, ow, K]
    xx = base_x + o[:, :, :, 1].permute(0, 1, 3, 4, 2)
    y0 = torch.floor(yy)
    x0 = torch.floor(xx)
    wy = yy - y0
    wx = xx - x0
    cpg = cin // dg
    src = a_p.reshape(n, dg, cpg, hp * wp)
    vals = 0
    for dy, dx, wgt_c in ((0, 0, (1 - wy) * (1 - wx)), (0, 1, (1 - wy) * wx),
                          (1, 0, wy * (1 - wx)), (1, 1, wy * wx)):
        yi = y0 + dy
        xi = x0 + dx
        inb = (yi >= 0) & (yi <= hp - 1) & (xi >= 0) & (xi <= wp - 1)
        idx = yi.clamp(0, hp - 1).long() * wp + xi.clamp(0, wp - 1).long()
        g = torch.gather(src, 3, idx.reshape(n, dg, 1, -1).expand(
            n, dg, cpg, oh * ow * K))
        vals = vals + g * (wgt_c * inb).reshape(n, dg, 1, -1)
    if msk is not None:
        mm = msk.reshape(n, dg, K, oh, ow).permute(0, 1, 3, 4, 2)
        vals = vals * mm.reshape(n, dg, 1, -1)
    cols = vals.reshape(n, groups, cin // groups, oh * ow, K)
    wg = wgt.reshape(groups, cout // groups, cin_g, K)
    out = torch.einsum('ngcpk,gock->ngop', cols, wg).reshape(n, cout, oh, ow)
    if b is not None:
        out = out + b.reshape(1, -1, 1, 1)
    return out


class DeformConv2D:
    """deform_conv2d over a Conv2D's weight and bias, a plain class as
    the JAX package's (its Conv2D on `device`, the current device when
    None)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None, *, device=None):
        from .. import nn
        self._layer = nn.Conv2D(in_channels, out_channels, kernel_size,
                                stride, padding, dilation, groups,
                                weight_attr=weight_attr, bias_attr=bias_attr,
                                device=device)
        self.args = (stride, padding, dilation, deformable_groups, groups)

    def __call__(self, x, offset, mask=None):
        s, p, d, dg, g = self.args
        return deform_conv2d(x, offset, self._layer.weight, self._layer.bias,
                             s, p, d, dg, g, mask)


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False,
                             rois_num=None, name=None):
    """Each roi to its FPN level (distribute_fpn_proposals_op), on the
    host: (the rois of each level, the restore index [R, 1], each
    level's roi count, per image when rois_num is given)."""
    dev = _device_of(fpn_rois)
    rois = _host(fpn_rois)
    off = 1.0 if pixel_offset else 0.0
    scale = np.sqrt(np.maximum((rois[:, 2] - rois[:, 0] + off) *
                               (rois[:, 3] - rois[:, 1] + off), 0))
    lvl = np.floor(np.log2(scale / refer_scale + 1e-6)) + refer_level
    lvl = np.clip(lvl, min_level, max_level).astype(np.int64)
    outs, idxs = [], []
    for l in range(min_level, max_level + 1):
        sel = np.flatnonzero(lvl == l)
        outs.append(_on(rois[sel], dev))
        idxs.append(sel)
    order = np.concatenate(idxs) if idxs else np.zeros(0, np.int64)
    restore = np.argsort(order)
    if rois_num is not None:
        # batched input: each level reports per-image counts (the
        # reference's rois_num_per_level), images delimited by rois_num
        rn = _host(rois_num).astype(np.int64).reshape(-1)
        img_of = np.repeat(np.arange(len(rn)), rn)
        out_num = [_on(np.bincount(img_of[i], minlength=len(rn))
                       .astype(np.int32), dev) for i in idxs]
    else:
        out_num = [_on(np.asarray([len(i)], np.int32), dev) for i in idxs]
    return outs, _on(restore.reshape(-1, 1), dev), out_num


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=False, return_rois_num=False, name=None):
    """RPN proposals (generate_proposals_v2_op), on the host: decode the
    top pre_nms_top_n anchors a image, clip, drop the small, NMS; (rois,
    their scores[, each image's count int32]) on the scores' device."""
    dev = _device_of(scores)
    s = _host(scores)
    d = _host(bbox_deltas)
    a = _host(anchors).reshape(-1, 4)
    v = _host(variances).reshape(-1, 4)
    imgs = _host(img_size)
    off = 1.0 if pixel_offset else 0.0
    n = s.shape[0]
    all_rois, all_scores, nums = [], [], []
    for b in range(n):
        sb = s[b].transpose(1, 2, 0).reshape(-1)
        db = d[b].transpose(1, 2, 0).reshape(-1, 4)
        order = np.argsort(-sb)[:pre_nms_top_n]
        sb, db, ab, vb = sb[order], db[order], a[order % len(a)], \
            v[order % len(v)]
        aw = ab[:, 2] - ab[:, 0] + off
        ah = ab[:, 3] - ab[:, 1] + off
        acx = ab[:, 0] + aw / 2
        acy = ab[:, 1] + ah / 2
        cx = db[:, 0] * vb[:, 0] * aw + acx
        cy = db[:, 1] * vb[:, 1] * ah + acy
        bw = np.exp(np.minimum(db[:, 2] * vb[:, 2], 10)) * aw
        bh = np.exp(np.minimum(db[:, 3] * vb[:, 3], 10)) * ah
        boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                         axis=-1)
        # clip to the image (proposal_op: boxes never exceed
        # [0, W - offset] x [0, H - offset])
        img_h, img_w = float(imgs[b][0]), float(imgs[b][1])
        boxes[:, 0] = np.clip(boxes[:, 0], 0, img_w - off)
        boxes[:, 1] = np.clip(boxes[:, 1], 0, img_h - off)
        boxes[:, 2] = np.clip(boxes[:, 2], 0, img_w - off)
        boxes[:, 3] = np.clip(boxes[:, 3], 0, img_h - off)
        bw_c = boxes[:, 2] - boxes[:, 0] + off
        bh_c = boxes[:, 3] - boxes[:, 1] + off
        eff_min = max(float(min_size), 1.0)  # the reference's FilterBoxes
        keep_mask = (bw_c >= eff_min) & (bh_c >= eff_min)
        boxes, sb = boxes[keep_mask], sb[keep_mask]
        iou = _iou_matrix(boxes, offset=off)
        keep = []
        supp = np.zeros(len(boxes), bool)
        adaptive = nms_thresh
        for i in range(len(boxes)):
            if supp[i]:
                continue
            keep.append(i)
            if len(keep) >= post_nms_top_n:
                break
            supp |= iou[i] > adaptive
            supp[i] = True
            if eta < 1.0 and adaptive > 0.5:
                # adaptive NMS: the threshold decays by eta
                adaptive *= eta
        all_rois.append(boxes[keep])
        all_scores.append(sb[keep])
        nums.append(len(keep))
    rois = _on(np.concatenate(all_rois), dev)
    rscores = _on(np.concatenate(all_scores), dev)
    if return_rois_num:
        return rois, rscores, _on(np.asarray(nums, np.int32), dev)
    return rois, rscores


def read_file(filename, name=None):
    """A file's bytes as a uint8 tensor (read_file_op), on the current
    device."""
    with open(filename, 'rb') as f:
        data = f.read()
    return _on(np.frombuffer(data, np.uint8), device_mod.resolve())


def decode_jpeg(x, mode='unchanged', name=None):
    """JPEG bytes -> an image tensor [C, H, W] uint8 on the bytes' device
    (the reference's decode_jpeg op decodes with nvjpeg; here PIL on the
    host)."""
    from PIL import Image
    img = Image.open(_io.BytesIO(_host(x).astype(np.uint8).tobytes()))
    if mode == 'gray':
        img = img.convert('L')
    elif mode == 'rgb':
        img = img.convert('RGB')
    arr = np.asarray(img)
    arr = arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    return _on(arr, _device_of(x))
