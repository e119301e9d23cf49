"""Detection ops (counterpart of paddle_tpu/vision/detection.py; reference:
paddle/fluid/operators/detection/ — matrix_nms_op.cc, multiclass_nms_op.cc,
iou_similarity_op.cc, box_clip_op.cc, sigmoid_focal_loss_op.cc,
anchor_generator_op.cc, bipartite_match_op.cc).

Every op is fixed-shape and mask-based, as the JAX package's: the
"variable-size" outputs come back padded to keep_top_k with label -1,
score -1, boxes -1 and index -1 rows, beside an int32 rois_num. The
batch runs as one batched computation where the JAX package vmaps.

Tie order is the JAX package's: its `argsort(-s)` is stable and its
`lax.top_k` puts the lowest index first among equal values, so both are
stable sorts here (`torch.topk` leaves tie order unspecified on CUDA).
matrix_nms and multiclass_nms run as the custom ops
`paddle_tpu_torch::matrix_nms` / `::multiclass_nms`, eager inside a
compiled program; the hard NMS's greedy loop is a fixed-point iteration
that reaches the loop's answer in a few batched steps.
"""
import math

import torch

from ..amp.auto_cast import cast as amp_cast

__all__ = ['iou_similarity', 'box_clip', 'sigmoid_focal_loss',
           'anchor_generator', 'bipartite_match', 'matrix_nms',
           'multiclass_nms', 'multiclass_nms2', 'multiclass_nms3']


def _pairwise_iou(a, b, normalized=True):
    """a [..., N, 4], b [..., M, 4] (x1, y1, x2, y2) -> [..., N, M]."""
    off = 0.0 if normalized else 1.0

    def area(box):
        return (box[..., 2] - box[..., 0] + off).clamp(min=0) * \
            (box[..., 3] - box[..., 1] + off).clamp(min=0)
    ax = area(a)[..., :, None]
    bx = area(b)[..., None, :]
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt + off).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (ax + bx - inter).clamp(min=1e-10)


def iou_similarity(x, y, box_normalized=True, name=None):
    """[N, 4] x [M, 4] -> [N, M] IoU (iou_similarity_op.cc)."""
    return _pairwise_iou(x, y, normalized=box_normalized)


def box_clip(input, im_shape, name=None):
    """Clip boxes to image bounds (box_clip_op.cc). input [..., N, 4],
    im_shape [..., 2] = (h, w); boxes clip to [0, w-1] x [0, h-1]."""
    im = im_shape.to(input.dtype)
    h = im[..., None, 0:1]
    w = im[..., None, 1:2]
    zero = torch.zeros((), dtype=input.dtype, device=input.device)

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, zero), hi - 1)
    return torch.cat([clip(input[..., 0:1], w), clip(input[..., 1:2], h),
                      clip(input[..., 2:3], w), clip(input[..., 3:4], h)],
                     dim=-1)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25,
                       gamma=2.0, reduction='sum', name=None):
    """Focal loss over sigmoid probabilities (sigmoid_focal_loss_op.cc;
    the modern paddle.nn.functional signature: label is a one- or
    multi-hot float)."""
    args = amp_cast('sigmoid_focal_loss', logit, label,
                    *([normalizer] if normalizer is not None else []))
    x, lab = args[0], args[1]
    p = torch.sigmoid(x)
    # max(x, 0) by torch.maximum: jnp.maximum's gradient at x = 0
    ce = torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device)) \
        - x * lab + torch.log1p(torch.exp(-x.abs()))
    p_t = p * lab + (1 - p) * (1 - lab)
    a_t = alpha * lab + (1 - alpha) * (1 - lab)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    if len(args) > 2:
        loss = loss / args[2]
    if reduction == 'sum':
        return loss.sum()
    if reduction == 'mean':
        return loss.mean()
    return loss


def anchor_generator(input, anchor_sizes, aspect_ratios, variances=None,
                     stride=None, offset=0.5, name=None):
    """Per-pixel anchors for an [N, C, H, W] feature map
    (anchor_generator_op.cc), on the map's device. Returns (anchors
    [H, W, A, 4], variances [H, W, A, 4])."""
    h, w = int(input.shape[-2]), int(input.shape[-1])
    sx, sy = (stride if stride else (16.0, 16.0))
    variances = variances or [0.1, 0.1, 0.2, 0.2]
    whs = []
    for ar in aspect_ratios:
        for size in anchor_sizes:
            whs.append((size * math.sqrt(1.0 / ar), size * math.sqrt(ar)))
    dev = input.device
    f32 = torch.float32
    whs = torch.tensor(whs, dtype=f32, device=dev)  # [A, 2]
    cx = (torch.arange(w, dtype=f32, device=dev) + offset) * sx
    cy = (torch.arange(h, dtype=f32, device=dev) + offset) * sy
    cyg, cxg = torch.meshgrid(cy, cx, indexing='ij')       # [H, W]
    centers = torch.stack([cxg, cyg], dim=-1)              # [H, W, 2]
    half = whs / 2.0
    mins = centers[:, :, None, :] - half[None, None, :, :]
    maxs = centers[:, :, None, :] + half[None, None, :, :]
    anchors = torch.cat([mins, maxs], dim=-1)
    var = torch.tensor(variances, dtype=f32, device=dev).expand(
        anchors.shape).contiguous()
    return anchors, var


def bipartite_match(dist_matrix, match_type='bipartite', dist_threshold=0.5,
                    name=None):
    """Greedy bipartite matching (bipartite_match_op.cc): repeatedly take
    the globally largest entry (the first in row-major order among
    equals, as argmax returns it), pair its row and column, exclude both;
    min(n, m) steps. Returns (match_indices [B, M] int32 row or -1,
    match_dist [B, M])."""
    d = dist_matrix if dist_matrix.dim() == 3 else dist_matrix[None]
    bsz, n, m = d.shape
    cur = d.clone()
    idx = torch.full((bsz, m), -1, dtype=torch.int32, device=d.device)
    dist = torch.zeros((bsz, m), dtype=d.dtype, device=d.device)
    rows = torch.arange(bsz, device=d.device)
    for _ in range(min(n, m)):
        flat = cur.reshape(bsz, -1).argmax(dim=1)
        i, j = flat // m, flat % m
        best = cur[rows, i, j]
        take = best > 0
        idx[rows, j] = torch.where(take, i.to(torch.int32), idx[rows, j])
        dist[rows, j] = torch.where(take, best, dist[rows, j])
        cur[rows, i, :] = torch.where(take[:, None], -1.0, cur[rows, i, :])
        cur[rows, :, j] = torch.where(take[:, None], -1.0, cur[rows, :, j])
    if match_type == 'per_prediction':
        # second pass: unmatched columns take their argmax row when the
        # distance clears the threshold
        col_dist, col_best = d.max(dim=1)
        extra = (idx < 0) & (col_dist >= dist_threshold)
        idx = torch.where(extra, col_best.to(torch.int32), idx)
        dist = torch.where(extra, col_dist, dist)
    return idx, dist


# -- NMS family --------------------------------------------------------------

def _argsort_desc(s, dim=-1):
    """argsort(-s) as the JAX package's stable argsort orders it."""
    return torch.sort(-s, dim=dim, stable=True).indices


def _top_k(flat, k):
    """lax.top_k over the last dim: the k largest, the lowest index first
    among equal values."""
    vals, pos = torch.sort(flat, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


def _candidates(boxes, scores, score_threshold, nms_top_k, background_label):
    """Each class's top min(nms_top_k, M) scores above the threshold (the
    background class and the rest at -1). boxes [B, M, 4], scores
    [B, C, M] -> (order [B, C, k], top_s [B, C, k], top_b [B, C, k, 4])."""
    B, C, M = scores.shape
    k = min(nms_top_k, M) if nms_top_k > 0 else M
    cls_ids = torch.arange(C, device=scores.device)
    s = torch.where((cls_ids == background_label)[:, None], -1.0, scores)
    s = torch.where(s > score_threshold, s, -1.0)
    order = _argsort_desc(s)[..., :k]
    top_s = torch.gather(s, 2, order)
    top_b = torch.gather(boxes[:, None].expand(B, C, M, 4), 2,
                         order[..., None].expand(B, C, k, 4))
    return order, top_s, top_b


def _keep_top(new_s, order, top_b, keep_top_k, dtype):
    """The best keep_top_k rows over all classes (label, score, box),
    padded with -1. new_s, order [B, C, k], top_b [B, C, k, 4] ->
    (out [B * K, 6], count [B] int32, index [B * K] int32)."""
    B, C, k = new_s.shape
    flat_s = new_s.reshape(B, -1)
    flat_lbl = torch.arange(C, device=new_s.device)[:, None].expand(
        C, k).reshape(-1)
    flat_box = top_b.reshape(B, -1, 4)
    flat_idx = order.reshape(B, -1)
    K = keep_top_k if keep_top_k > 0 else flat_s.shape[1]
    K = min(K, flat_s.shape[1])
    kept_s, kept_pos = _top_k(flat_s, K)
    valid = kept_s > 0
    lbl = torch.where(valid, flat_lbl[kept_pos], -1).to(dtype)
    box = torch.gather(flat_box, 1, kept_pos[..., None].expand(B, K, 4))
    out = torch.cat([lbl[..., None],
                     torch.where(valid, kept_s, -1.0)[..., None],
                     torch.where(valid[..., None], box, -1.0)], dim=2)
    index = torch.where(valid, torch.gather(flat_idx, 1, kept_pos),
                        -1).to(torch.int32)
    return (out.reshape(-1, 6), valid.to(torch.int32).sum(1, dtype=torch.int32),
            index.reshape(-1))


def _results(out, counts, index, return_index, return_rois_num):
    res = [out]
    if return_index:
        res.append(index)
    if return_rois_num:
        res.append(counts)
    return tuple(res) if len(res) > 1 else res[0]


def _nms_fake(bboxes, scores, nms_top_k, keep_top_k):
    """The NMS ops' outputs as shapes: out [B * K, 6], counts [B],
    index [B * K]."""
    B, C, M = scores.shape
    k = min(nms_top_k, M) if nms_top_k > 0 else M
    K = min(keep_top_k if keep_top_k > 0 else C * k, C * k)
    return (bboxes.new_empty((B * K, 6)),
            scores.new_empty((B,), dtype=torch.int32),
            scores.new_empty((B * K,), dtype=torch.int32))


# The NMS family as custom operators: a compiled program (the fluid op
# table compiles whole blocks) calls them as they are and runs them
# eagerly inside, as it runs the fused loss. Inductor would lower a
# class's stable sort of up to ~1000 candidates to a Triton sort kernel
# that took 45 s to compile on an H100 (yolo_compile_probe.py).
@torch.library.custom_op('paddle_tpu_torch::matrix_nms', mutates_args=())
def matrix_nms_op(bboxes: torch.Tensor, scores: torch.Tensor,
                  score_threshold: float, post_threshold: float,
                  nms_top_k: int, keep_top_k: int, use_gaussian: bool,
                  gaussian_sigma: float, background_label: int,
                  normalized: bool
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out [B * K, 6], counts [B] int32, index [B * K] int32)."""
    order, top_s, top_b = _candidates(bboxes, scores, score_threshold,
                                      nms_top_k, background_label)
    k = order.shape[-1]
    iou = _pairwise_iou(top_b, top_b, normalized)         # [B, C, k, k]
    # tri[j, i] iff i < j: row j is the candidate, column i its
    # (higher-scored) potential suppressor
    tri = torch.ones((k, k), dtype=torch.bool,
                     device=iou.device).tril(-1)
    iou_ji = torch.where(tri, iou, 0.0)
    # compensate_i = max over l < i of iou_li, broadcast on column i
    comp_i = iou_ji.amax(dim=3)[..., None, :]
    if use_gaussian:
        decay = torch.exp(-(iou_ji ** 2 - comp_i ** 2) / gaussian_sigma)
    else:
        decay = (1.0 - iou_ji) / (1.0 - comp_i).clamp(min=1e-10)
    decay = torch.where(tri, decay, 1.0).amin(dim=3)
    new_s = torch.where(top_s > 0, top_s * decay, -1.0)
    new_s = torch.where(new_s > post_threshold, new_s, -1.0)
    return _keep_top(new_s, order, top_b, keep_top_k, bboxes.dtype)


@matrix_nms_op.register_fake
def _matrix_nms_fake(bboxes, scores, score_threshold, post_threshold,
                     nms_top_k, keep_top_k, *args):
    return _nms_fake(bboxes, scores, nms_top_k, keep_top_k)


def matrix_nms(bboxes, scores, score_threshold, post_threshold=0.0,
               nms_top_k=400, keep_top_k=200, use_gaussian=False,
               gaussian_sigma=2.0, background_label=0, normalized=True,
               return_index=False, return_rois_num=True, name=None):
    """Matrix NMS (matrix_nms_op.cc; SOLOv2's decay): per class, each
    candidate's score decays by the most-suppressing higher-scored box,
    the suppressor's own overlap compensated. bboxes [B, M, 4], scores
    [B, C, M]. Returns out [B * K, 6] (label, score, x1 y1 x2 y2; padded
    rows label -1), optional index [B * K], rois_num [B]."""
    res = matrix_nms_op(bboxes, scores, float(score_threshold),
                        float(post_threshold), int(nms_top_k),
                        int(keep_top_k), bool(use_gaussian),
                        float(gaussian_sigma), int(background_label),
                        bool(normalized))
    return _results(*res, return_index, return_rois_num)


def _suppress(iou, valid, threshold):
    """Greedy hard NMS over score-ordered candidates: iou [..., k, k],
    valid [..., k] -> kept [..., k], where candidate j is kept iff it is
    valid and no kept i < j overlaps it above `threshold`.

    That recursion has one solution, the greedy loop's (kept[j] depends
    only on kept[:j]), and its iteration from kept = valid is right on
    one more leading entry each step: iterated to a fixed point it gives
    the greedy loop's answer in as many steps as the longest chain of
    suppressions, at most k + 1 (one host read a step)."""
    k = iou.shape[-1]
    upper = torch.ones((k, k), dtype=torch.bool, device=iou.device).triu(1)
    over = (iou > threshold) & upper                    # [..., i, j]
    kept = valid
    for _ in range(k + 1):
        nxt = valid & ~(kept[..., :, None] & over).any(dim=-2)
        if torch.equal(nxt, kept):
            break
        kept = nxt
    return kept


@torch.library.custom_op('paddle_tpu_torch::multiclass_nms',
                         mutates_args=())
def multiclass_nms_op(bboxes: torch.Tensor, scores: torch.Tensor,
                      score_threshold: float, nms_top_k: int,
                      keep_top_k: int, nms_threshold: float,
                      normalized: bool, background_label: int
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out [B * K, 6], counts [B] int32, index [B * K] int32)."""
    order, top_s, top_b = _candidates(bboxes, scores, score_threshold,
                                      nms_top_k, background_label)
    iou = _pairwise_iou(top_b, top_b, normalized)
    kept = _suppress(iou, top_s > 0, nms_threshold)
    new_s = torch.where(kept, top_s, -1.0)
    return _keep_top(new_s, order, top_b, keep_top_k, bboxes.dtype)


@multiclass_nms_op.register_fake
def _multiclass_nms_fake(bboxes, scores, score_threshold, nms_top_k,
                         keep_top_k, *args):
    return _nms_fake(bboxes, scores, nms_top_k, keep_top_k)


def multiclass_nms(bboxes, scores, score_threshold=0.05, nms_top_k=1000,
                   keep_top_k=100, nms_threshold=0.3, normalized=True,
                   nms_eta=1.0, background_label=0, return_index=False,
                   return_rois_num=True, rois_num=None, name=None):
    """Per-class hard NMS + cross-class keep_top_k (multiclass_nms_op.cc).
    bboxes [B, M, 4], scores [B, C, M]. The same padded outputs as
    matrix_nms."""
    res = multiclass_nms_op(bboxes, scores, float(score_threshold),
                            int(nms_top_k), int(keep_top_k),
                            float(nms_threshold), bool(normalized),
                            int(background_label))
    return _results(*res, return_index, return_rois_num)


def multiclass_nms2(bboxes, scores, **kwargs):
    """multiclass_nms + the kept boxes' index (multiclass_nms2 op)."""
    kwargs['return_index'] = True
    return multiclass_nms(bboxes, scores, **kwargs)


def multiclass_nms3(bboxes, scores, rois_num=None, **kwargs):
    """The rois_num-in / rois_num-out variant (multiclass_nms3 op)."""
    kwargs.setdefault('return_rois_num', True)
    return multiclass_nms(bboxes, scores, rois_num=rois_num, **kwargs)
