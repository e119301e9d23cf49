"""The port's detection ops (paddle_tpu_torch/vision/detection.py and
vision/ops.py) against the JAX package's on the same seeded numpy inputs,
as tests/test_detection_ops.py covers them.

Tolerances: 1e-6 for elementwise f32 (relative, at least 1e-6 absolute);
exact for indices, labels, counts and the boxes NMS keeps. The NMS cases
hold deliberately equal scores, so the two packages must break ties the
same way (the JAX argsort is stable, its top_k puts the lowest index
first). yolo_loss and sigmoid_focal_loss are held on the value and on
the gradient with respect to x, the JAX gradient taken through its tape
(`loss.backward()`); yolo_loss has two ground-truth boxes on one anchor
and cell, whose objectness target is a scatter-max.

deform_conv2d: the JAX function raises TypeError on every input (a 5-d
gather broadcast against a 6-d weight), which one case pins. The port is
held three ways instead: to conv2d with zero offsets and a unit mask; to
a numpy loop written here from Paddle's deformable_conv formula, with
fractional offsets, samples outside the map, 2 deformable groups, 2
groups, a mask and a bias; and by torch.autograd.gradcheck in float64.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
from paddle_tpu.framework.core import Tensor as JTensor
from paddle_tpu.vision import detection as JD
from paddle_tpu.vision import ops as JO

from paddle_tpu_torch.framework import device as device_mod
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.vision import detection as TD
from paddle_tpu_torch.vision import ops as TO

TOL = 1e-6


def _np(x):
    if torch.is_tensor(x):
        return x.detach().numpy()
    return np.asarray(x.numpy() if hasattr(x, 'numpy') else x)


def _close(got, want, tol=TOL, msg=''):
    """Within tol of each entry, or of the largest |value| (at least 1):
    a difference of close values (a box's corner) keeps the error of its
    terms."""
    want = _np(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol * scale,
                               err_msg=msg)


def _equal(got, want, msg=''):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=msg)


def _j(a):
    return paddle.to_tensor(a)


def _t(a):
    return torch.tensor(a)


def _boxes(rng, shape, scale=1.0):
    b = rng.rand(*shape, 4).astype(np.float32) * scale
    b[..., 2:] = b[..., :2] + rng.rand(*shape, 2).astype(np.float32) * \
        0.5 * scale
    return b


def _unwrap(out):
    return jax.tree_util.tree_map(lambda t: t._data, out,
                                  is_leaf=lambda t: isinstance(t, JTensor))


def _jax(fn, *arrays):
    """The JAX fn(*Tensors) on numpy arrays, traced and compiled once by
    jax.jit (op-by-op it compiles a program a primitive): its outputs as
    numpy, in its structure."""
    out = jax.jit(lambda *a: _unwrap(fn(*[JTensor(v) for v in a])))(*arrays)
    return jax.tree_util.tree_map(np.asarray, out)


def _jax_tape(fn, x):
    """fn(x)'s value and d sum(value) / dx from the JAX package's tape
    (`backward()` on a Tensor that needs its gradient), under jax.jit."""
    def tape(a):
        xt = JTensor(a)
        xt.stop_gradient = False
        out = fn(xt)
        out.sum().backward()
        return out._data, xt.grad._data
    out, grad = jax.jit(tape)(x)
    return np.asarray(out), np.asarray(grad)


def _torch_grad(fn, x, *rest):
    xt = torch.tensor(x, requires_grad=True)
    out = fn(xt, *rest)
    out.sum().backward()
    return out.detach().numpy(), xt.grad.numpy()


# ---- detection.py ----------------------------------------------------------

def test_iou_similarity_and_box_clip():
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, (5,)), _boxes(rng, (7,))
    for norm in (True, False):
        _close(TD.iou_similarity(_t(a * 9), _t(b * 9), box_normalized=norm),
               _jax(lambda x, y: JD.iou_similarity(x, y, norm), a * 9,
                    b * 9))
    boxes = (rng.rand(2, 6, 4) * 60 - 10).astype(np.float32)
    im = np.asarray([[40.0, 50.0], [30.0, 30.0]], np.float32)
    _equal(TD.box_clip(_t(boxes), _t(im)), _jax(JD.box_clip, boxes, im))


@pytest.mark.parametrize('reduction', ['sum', 'mean', 'none'])
def test_sigmoid_focal_loss_value_and_grad(reduction):
    rng = np.random.RandomState(1)
    x = rng.randn(4, 6).astype(np.float32) * 2
    lab = (rng.rand(4, 6) > 0.6).astype(np.float32)
    norm = np.asarray([3.0], np.float32)
    want, wgrad = _jax_tape(
        lambda a: JD.sigmoid_focal_loss(a, JTensor(lab), JTensor(norm),
                                        reduction=reduction), x)
    got, grad = _torch_grad(
        lambda a: TD.sigmoid_focal_loss(a, _t(lab), _t(norm),
                                        reduction=reduction), x)
    _close(got, want)
    _close(grad, wgrad)


def test_anchor_generator_matches_jax():
    x = np.zeros((1, 8, 3, 5), np.float32)
    kw = dict(anchor_sizes=[32, 64, 128], aspect_ratios=[0.5, 1.0, 2.0],
              stride=[16.0, 8.0], offset=0.25,
              variances=[0.1, 0.2, 0.3, 0.4])
    for got, want in zip(TD.anchor_generator(_t(x), **kw),
                         _jax(lambda a: JD.anchor_generator(a, **kw), x)):
        _equal(got, want)


@pytest.mark.parametrize('match_type', ['bipartite', 'per_prediction'])
@pytest.mark.parametrize('shape', [(2, 5, 7), (1, 6, 3)])
def test_bipartite_match_matches_jax(match_type, shape):
    """Rounded distances: equal entries, which the first maximum in
    row-major order decides."""
    rng = np.random.RandomState(2)
    d = np.round(rng.rand(*shape), 1).astype(np.float32)
    d[0, 0, :] = 0.0  # a row with nothing to match
    got = TD.bipartite_match(_t(d), match_type, dist_threshold=0.35)
    want = _jax(lambda a: JD.bipartite_match(a, match_type,
                                             dist_threshold=0.35), d)
    _equal(got[0], want[0], 'indices')
    _equal(got[1], want[1], 'distances')
    assert got[0].dtype == torch.int32
    got2 = TD.bipartite_match(_t(d[0]), match_type, dist_threshold=0.35)
    _equal(got2[0], want[0][:1])


def _nms_inputs(seed, B=2, M=24, C=4, scale=1.0):
    """Boxes, and scores rounded to a tenth so many are equal, within
    and across classes."""
    rng = np.random.RandomState(seed)
    boxes = _boxes(rng, (B, M), scale)
    scores = (rng.randint(0, 10, (B, C, M)) / 10).astype(np.float32)
    return boxes, scores


NMS_CASES = {
    'matrix_linear': ('matrix_nms', dict(
        score_threshold=0.15, post_threshold=0.05, nms_top_k=16,
        keep_top_k=10, use_gaussian=False, return_index=True)),
    'matrix_gaussian': ('matrix_nms', dict(
        score_threshold=0.15, post_threshold=0.05, nms_top_k=-1,
        keep_top_k=12, use_gaussian=True, gaussian_sigma=2.0,
        return_index=True, background_label=-1)),
    'matrix_pixels': ('matrix_nms', dict(
        score_threshold=0.25, nms_top_k=20, keep_top_k=-1,
        normalized=False, background_label=2, return_index=True)),
    'hard': ('multiclass_nms', dict(
        score_threshold=0.15, nms_top_k=16, keep_top_k=8,
        nms_threshold=0.3)),
    'hard_pixels_no_bg': ('multiclass_nms', dict(
        score_threshold=0.05, nms_top_k=-1, keep_top_k=30,
        nms_threshold=0.2, normalized=False, background_label=-1,
        return_index=True)),
    'nms2': ('multiclass_nms2', dict(
        score_threshold=0.15, nms_top_k=10, keep_top_k=6,
        nms_threshold=0.45, background_label=1)),
    'nms3': ('multiclass_nms3', dict(
        score_threshold=0.15, nms_top_k=12, keep_top_k=50,
        nms_threshold=0.5, return_index=True)),
}


@pytest.mark.parametrize('case', sorted(NMS_CASES))
def test_nms_family_matches_jax_with_ties(case):
    name, kw = NMS_CASES[case]
    scale = 30.0 if kw.get('normalized') is False else 1.0
    boxes, scores = _nms_inputs(3, scale=scale)
    got = getattr(TD, name)(_t(boxes), _t(scores), **kw)
    want = _jax(lambda b, s: getattr(JD, name)(b, s, **kw), boxes, scores)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    out, wout = got[0].numpy(), want[0]
    _equal(out[:, 0], wout[:, 0], 'labels')
    _close(out[:, 1], wout[:, 1], msg='scores')
    _equal(out[:, 2:], wout[:, 2:], 'boxes')
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.int32
        _equal(g, w, 'index / rois_num')
    # padded rows are -1 throughout
    pad = out[:, 0] == -1
    assert (out[pad] == -1).all()


def test_nms_ops_trace_as_custom_ops():
    """matrix_nms and multiclass_nms are custom ops: a full-graph compile
    calls them as they are (their fake gives the outputs' shapes) and
    gives the eager rows."""
    boxes, scores = _nms_inputs(5)
    b, s = _t(boxes), _t(scores)
    for fn in (lambda x, y: TD.matrix_nms(x, y, 0.15, nms_top_k=16,
                                          keep_top_k=10, return_index=True),
               lambda x, y: TD.multiclass_nms(x, y, 0.15, nms_top_k=-1,
                                              keep_top_k=-1,
                                              return_index=True)):
        torch._dynamo.reset()
        got = torch.compile(fn, fullgraph=True, backend='aot_eager')(b, s)
        for g, w in zip(got, fn(b, s)):
            assert g.dtype == w.dtype
            _equal(g, w)


# ---- ops.py: device ops ----------------------------------------------------

YOLO_BOX_CASES = {
    'plain': dict(conf_thresh=0.01, downsample_ratio=32),
    'conf_mask_no_clip': dict(conf_thresh=0.5, downsample_ratio=16,
                              clip_bbox=False),
    'iou_aware_scale_xy': dict(conf_thresh=0.05, downsample_ratio=8,
                               scale_x_y=1.05, iou_aware=True,
                               iou_aware_factor=0.4),
}


@pytest.mark.parametrize('case', sorted(YOLO_BOX_CASES))
def test_yolo_box_matches_jax(case):
    kw = YOLO_BOX_CASES[case]
    na, cls, h, w = 3, 4, 4, 5
    c = na * (5 + cls) + (na if kw.get('iou_aware') else 0)
    head = np.random.RandomState(4).randn(2, c, h, w).astype(np.float32)
    img = np.asarray([[128, 160], [96, 100]], np.int32)
    args = dict(anchors=[10, 13, 16, 30, 33, 23], class_num=cls, **kw)
    got = TO.yolo_box(_t(head), _t(img), **args)
    want = _jax(lambda a, i: JO.yolo_box(a, i, **args), head, img)
    for g, wv in zip(got, want):
        _close(g, wv)
    if kw['conf_thresh'] >= 0.5:
        assert (got[1].numpy() == 0).any()  # the confidence mask bites


def test_yolo_box_layout_independent_eager_and_compiled():
    """A channels-last head (what Inductor's layout optimisation gives a
    compiled program's convolutions) decodes as the contiguous head does,
    eagerly and compiled, at the 10 x 10 head and batch where the stacked
    box layout went wrong on the card (yolo_layout_probe.py)."""
    head = torch.from_numpy(np.random.RandomState(9).randn(
        2, 3 * (5 + 4), 10, 10).astype(np.float32))
    img = torch.full((2, 2), 320, dtype=torch.int32)
    args = dict(anchors=[116, 90, 156, 198, 373, 326], class_num=4,
                conf_thresh=0.005, downsample_ratio=32)
    want = TO.yolo_box(head, img, **args)
    cl = head.contiguous(memory_format=torch.channels_last)
    torch._dynamo.reset()
    compiled = torch.compile(lambda a, b: TO.yolo_box(a, b, **args),
                             fullgraph=True, dynamic=False)
    for got in (TO.yolo_box(cl, img, **args), compiled(cl, img)):
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                       atol=1e-5)


# two ground truths on one anchor and cell (the objectness target is the
# larger weight, not the sum nor the last write), one matching an anchor
# outside the mask, and a padded (w = 0) box
YOLO_GT = np.asarray([[[0.5, 0.5, 0.3, 0.4], [0.52, 0.55, 0.31, 0.41],
                       [0.1, 0.9, 0.9, 0.8]],
                      [[0.3, 0.6, 0.2, 0.2], [0.7, 0.2, 0.1, 0.3],
                       [0.0, 0.0, 0.0, 0.0]]], np.float32)
YOLO_LABEL = np.asarray([[1, 2, 3], [0, 3, -1]], np.int64)
YOLO_LOSS_CASES = {
    'default': dict(anchor_mask=[0, 1, 2], ignore_thresh=0.7),
    'scores_scale_no_smooth': dict(
        anchor_mask=[1, 2, 3], ignore_thresh=0.5, scale_x_y=1.05,
        use_label_smooth=False,
        gt_score=np.asarray([[0.7, 0.9, 1.0], [1.0, 0.4, 0.0]], np.float32)),
}


@pytest.mark.parametrize('case', sorted(YOLO_LOSS_CASES))
def test_yolo_loss_value_and_grad(case):
    kw = dict(YOLO_LOSS_CASES[case])
    na, cls, h = len(kw['anchor_mask']), 4, 5
    x = np.random.RandomState(5).randn(2, na * (5 + cls), h, h).astype(
        np.float32)
    anchors = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45]
    score = kw.pop('gt_score', None)

    def run(mk, fn):
        extra = {} if score is None else {'gt_score': mk(score)}
        return lambda a: fn(a, mk(YOLO_GT), mk(YOLO_LABEL), anchors=anchors,
                            class_num=cls, downsample_ratio=32, **kw,
                            **extra)
    want, wgrad = _jax_tape(run(JTensor, JO.yolo_loss), x)
    got, grad = _torch_grad(run(_t, TO.yolo_loss), x)
    assert got.shape == (2,)
    _close(got, want)
    _close(grad, wgrad)


def test_yolo_loss_objectness_target_is_a_scatter_max():
    """Both boxes of image 0 land on anchor 2 of cell (2, 2): with
    scores 0.7 and 0.9 the target there is 0.9 (not their sum 1.6, nor
    the last write), so at x = 0 the loss's gradient at that objectness
    logit is jnp.maximum's 0.5 at the tie less the target."""
    na, cls, h = 3, 4, 5
    x = np.zeros((1, na * (5 + cls), h, h), np.float32)
    gt = YOLO_GT[:1, :2]
    xt = torch.tensor(x, requires_grad=True)
    TO.yolo_loss(xt, _t(gt), _t(YOLO_LABEL[:1, :2]),
                 anchors=[10, 13, 16, 30, 33, 23], anchor_mask=[0, 1, 2],
                 class_num=cls, ignore_thresh=0.7, downsample_ratio=32,
                 gt_score=_t(np.asarray([[0.7, 0.9]], np.float32))
                 ).sum().backward()
    g = xt.grad.reshape(na, 5 + cls, h, h)
    assert abs(g[2, 4, 2, 2].item() - (0.5 - 0.9)) < 1e-6


ROI_CASES = {
    'aligned_s2': dict(output_size=2, spatial_scale=0.5, sampling_ratio=2),
    'unaligned_one_sample': dict(output_size=(3, 2), sampling_ratio=-1,
                                 aligned=False),
    'dense_s3': dict(output_size=(2, 3), spatial_scale=0.25,
                     sampling_ratio=3),
}


@pytest.mark.parametrize('case', sorted(ROI_CASES))
def test_roi_align_matches_jax_past_the_edge(case):
    kw = ROI_CASES[case]
    rng = np.random.RandomState(6)
    x = rng.randn(2, 3, 8, 8).astype(np.float32)
    scale = kw.get('spatial_scale', 1.0)
    # the last two reach past the map: their samples extrapolate
    rois = np.asarray([[1, 1, 6, 6], [0, 2, 3, 7], [5, 5, 7.5, 6.5],
                       [-3, -2, 9, 11], [6, 6, 12, 10]], np.float32) / scale
    num = np.asarray([3, 2], np.int32)
    _close(TO.roi_align(_t(x), _t(rois), _t(num), **kw),
           _jax(lambda a, r, n: JO.roi_align(a, r, n, **kw), x, rois, num))


def test_roi_pool_and_the_layers_match_jax():
    rng = np.random.RandomState(7)
    x = rng.randn(1, 2, 6, 6).astype(np.float32)
    rois = np.asarray([[0.5, 0.5, 4, 5], [1, 0, 5.5, 3]], np.float32)
    num = np.asarray([2], np.int32)
    _close(TO.roi_pool(_t(x), _t(rois), _t(num), 2),
           _jax(lambda a, r, n: JO.roi_pool(a, r, n, 2), x, rois, num))
    for cls in ('RoIAlign', 'RoIPool', 'PSRoIPool'):
        _close(getattr(TO, cls)(3, 0.5)(_t(x), _t(rois), _t(num)),
               _jax(getattr(JO, cls)(3, 0.5), x, rois, num), msg=cls)
    _close(TO.RoIAlign(2)(_t(x), _t(rois), _t(num), aligned=False),
           TO.roi_pool(_t(x), _t(rois), _t(num), 2))


BOX_CODER_CASES = {
    'encode_list_var': dict(code_type='encode_center_size', var='list'),
    'encode_tensor_var_pixels': dict(code_type='encode_center_size',
                                     var='tensor', box_normalized=False),
    'decode_axis0': dict(code_type='decode_center_size', var='tensor',
                         target=(3, 2), axis=0),
    'decode_axis1_pixels': dict(code_type='decode_center_size', var='list',
                                target=(2, 3), axis=1,
                                box_normalized=False),
    'decode_2d': dict(code_type='decode_center_size', var='tensor',
                      target=(2,)),
}


@pytest.mark.parametrize('case', sorted(BOX_CODER_CASES))
def test_box_coder_matches_jax(case):
    kw = dict(BOX_CODER_CASES[case])
    rng = np.random.RandomState(8)
    priors = _boxes(rng, (2,), 10.0) + 1.0
    var_t = rng.uniform(0.1, 0.3, (2, 4)).astype(np.float32)
    var = [0.1, 0.1, 0.2, 0.2] if kw.pop('var') == 'list' else var_t
    shape = kw.pop('target', None)
    target = _boxes(rng, (3,), 10.0) + 0.5 if shape is None else \
        (rng.randn(*shape, 4) * 0.3).astype(np.float32)
    tvar = var if isinstance(var, list) else _t(var)
    jvar = var if isinstance(var, list) else JTensor(var)
    _close(TO.box_coder(_t(priors), tvar, _t(target), **kw),
           _jax(lambda p, t: JO.box_coder(p, jvar, t, **kw), priors,
                target), tol=2e-6)


@pytest.mark.parametrize('order', [False, True])
def test_prior_box_matches_jax(order):
    feat = np.zeros((1, 8, 3, 4), np.float32)
    img = np.zeros((1, 3, 48, 64), np.float32)
    for kw in (dict(min_sizes=[16.0, 24.0], max_sizes=[32.0, 40.0],
                    aspect_ratios=[1.0, 2.0], flip=True),
               dict(min_sizes=[20.0], aspect_ratios=[0.5, 3.0], clip=True,
                    steps=(12.0, 20.0), offset=0.3,
                    variance=(0.1, 0.2, 0.3, 0.4))):
        got = TO.prior_box(_t(feat), _t(img),
                           min_max_aspect_ratios_order=order, **kw)
        want = JO.prior_box(_j(feat), _j(img),
                            min_max_aspect_ratios_order=order, **kw)
        for g, w in zip(got, want):
            _equal(g, w)


# ---- ops.py: host ops ------------------------------------------------------

def test_nms_matches_jax_with_categories_and_top_k():
    rng = np.random.RandomState(9)
    boxes = _boxes(rng, (20,), 50.0)
    scores = (rng.randint(0, 8, 20) / 8).astype(np.float32)
    cats = rng.randint(0, 3, 20).astype(np.int64)
    for kw in (dict(iou_threshold=0.3, scores=scores),
               dict(iou_threshold=0.2, scores=scores, category_idxs=cats,
                    categories=[0, 2], top_k=5),
               dict(iou_threshold=0.5, category_idxs=cats, top_k=7),
               dict(iou_threshold=0.4)):
        tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v)
               for k, v in kw.items()}
        jkw = {k: (_j(v) if isinstance(v, np.ndarray) else v)
               for k, v in kw.items()}
        got = TO.nms(_t(boxes), **tkw)
        assert got.dtype == torch.int64
        _equal(got, JO.nms(_j(boxes), **jkw).numpy().astype(np.int64),
               str(sorted(kw)))
    with pytest.raises(ValueError, match='category_idxs'):
        TO.nms(_t(boxes), scores=_t(scores), categories=[0])


@pytest.mark.parametrize('kw', [
    dict(return_rois_num=True),
    dict(pixel_offset=True, min_size=2.0, return_rois_num=True,
         post_nms_top_n=5),
    dict(nms_thresh=0.9, eta=0.5, pre_nms_top_n=20)],
    ids=['rois_num', 'pixel_offset', 'eta'])
def test_generate_proposals_matches_jax(kw):
    rng = np.random.RandomState(10)
    n, a, h, w = 2, 3, 4, 4
    scores = rng.rand(n, a, h, w).astype(np.float32)
    deltas = (rng.randn(n, a * 4, h, w) * 0.5).astype(np.float32)
    anchors = rng.rand(h, w, a, 4).astype(np.float32) * 8
    anchors[..., 2:] += 10
    variances = np.full_like(anchors, 0.5)
    img = np.asarray([[24.0, 28.0], [20.0, 22.0]], np.float32)
    got = TO.generate_proposals(_t(scores), _t(deltas), _t(img),
                                _t(anchors), _t(variances), **kw)
    want = JO.generate_proposals(_j(scores), _j(deltas), _j(img),
                                 _j(anchors), _j(variances), **kw)
    assert len(got) == len(want)
    _close(got[0], want[0])
    _close(got[1], want[1])
    if len(got) == 3:
        assert got[2].dtype == torch.int32
        _equal(got[2], want[2])


@pytest.mark.parametrize('batched', [False, True])
def test_distribute_fpn_proposals_matches_jax(batched):
    rng = np.random.RandomState(11)
    rois = _boxes(rng, (9,), 300.0)
    kw = dict(pixel_offset=batched)
    if batched:
        kw['rois_num'] = np.asarray([4, 5], np.int32)
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    jkw = {k: (_j(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    got = TO.distribute_fpn_proposals(_t(rois), 2, 5, 4, 112, **tkw)
    want = JO.distribute_fpn_proposals(_j(rois), 2, 5, 4, 112, **jkw)
    assert len(got[0]) == len(want[0]) == 4
    for g, w in zip(got[0], want[0]):
        _equal(g, w)
    _equal(got[1], want[1].numpy().astype(np.int64))
    for g, w in zip(got[2], want[2]):
        assert g.dtype == torch.int32
        _equal(g, w)


@pytest.mark.parametrize('mode', ['unchanged', 'gray', 'rgb'])
def test_read_file_and_decode_jpeg_match_jax(tmp_path, monkeypatch, mode):
    """read_file puts the bytes on the current device (the CPU here);
    decode_jpeg decodes on the host onto the bytes' device."""
    from PIL import Image
    monkeypatch.setitem(device_mod._STATE, 'device', 'cpu')
    rng = np.random.RandomState(12)
    path = str(tmp_path / 'img.jpg')
    Image.fromarray(rng.randint(0, 255, (10, 14, 3)).astype(np.uint8)).save(
        path, quality=90)
    raw = TO.read_file(path)
    assert raw.dtype == torch.uint8 and raw.device.type == 'cpu'
    _equal(raw, JO.read_file(path).numpy())
    _equal(TO.decode_jpeg(raw, mode=mode),
           JO.decode_jpeg(JO.read_file(path), mode=mode).numpy())


# ---- deform_conv2d ---------------------------------------------------------

def _deform_ref(x, offset, weight, bias, stride, pad, dil, dg, groups, mask):
    """Paddle's deformable convolution, one output at a time: zero-pad,
    sample each kernel point at its base + offset bilinearly (a corner
    counts only inside the padded map), times the mask, then the grouped
    product with the weight, plus the bias."""
    n, cin, h, w = x.shape
    cout, cin_g, kh, kw = weight.shape
    oh = (h + 2 * pad - dil * (kh - 1) - 1) // stride + 1
    ow = (w + 2 * pad - dil * (kw - 1) - 1) // stride + 1
    xp = np.pad(x.astype(np.float64), [(0, 0), (0, 0), (pad, pad),
                                       (pad, pad)])
    hp, wp = xp.shape[2:]
    cpg = cin // dg
    cols = np.zeros((n, cin, kh * kw, oh, ow))
    for b in range(n):
        for c in range(cin):
            g = c // cpg
            for k in range(kh * kw):
                ky, kx = divmod(k, kw)
                for i in range(oh):
                    for j in range(ow):
                        y = i * stride + ky * dil + \
                            offset[b, (g * kh * kw + k) * 2, i, j]
                        xx = j * stride + kx * dil + \
                            offset[b, (g * kh * kw + k) * 2 + 1, i, j]
                        y0, x0 = int(np.floor(y)), int(np.floor(xx))
                        val = 0.0
                        for yi, xi, wt in (
                                (y0, x0, (1 - (y - y0)) * (1 - (xx - x0))),
                                (y0, x0 + 1, (1 - (y - y0)) * (xx - x0)),
                                (y0 + 1, x0, (y - y0) * (1 - (xx - x0))),
                                (y0 + 1, x0 + 1, (y - y0) * (xx - x0))):
                            if 0 <= yi < hp and 0 <= xi < wp:
                                val += wt * xp[b, c, yi, xi]
                        if mask is not None:
                            val *= mask[b, g * kh * kw + k, i, j]
                        cols[b, c, k, i, j] = val
    out = np.zeros((n, cout, oh, ow))
    cout_g = cout // groups
    for o in range(cout):
        g = o // cout_g
        for c in range(cin_g):
            for k in range(kh * kw):
                out[:, o] += weight[o, c].reshape(-1)[k] * \
                    cols[:, g * cin_g + c, k]
        if bias is not None:
            out[:, o] += bias[o]
    return out


def test_deform_conv2d_zero_offsets_is_conv2d():
    rng = np.random.RandomState(13)
    x = _t(rng.randn(2, 4, 7, 6).astype(np.float32))
    w = _t(rng.randn(6, 2, 3, 3).astype(np.float32))
    b = _t(rng.randn(6).astype(np.float32))
    off = torch.zeros(2, 2 * 9 * 2, 4, 3)
    mask = torch.ones(2, 2 * 9, 4, 3)
    got = TO.deform_conv2d(x, off, w, b, stride=2, padding=1, dilation=1,
                           deformable_groups=2, groups=2, mask=mask)
    _close(got, TF.conv2d(x, w, b, stride=2, padding=1, groups=2), tol=1e-5)
    # v1 (no mask) and the static builder, which passes through
    _close(tstatic.nn.deform_conv2d(x, off, w, b, 2, 1, 1, 2, 2), got)


def test_deform_conv2d_matches_the_formula():
    """Fractional offsets reaching past the map, 2 deformable groups, 2
    groups, a mask and a bias, stride 2, dilation 2, padding 1."""
    rng = np.random.RandomState(14)
    n, cin, h, w, cout, k, dg, groups = 2, 4, 7, 8, 6, 3, 2, 2
    stride, pad, dil = 2, 1, 2
    oh = (h + 2 * pad - dil * (k - 1) - 1) // stride + 1
    ow = (w + 2 * pad - dil * (k - 1) - 1) // stride + 1
    x = rng.randn(n, cin, h, w).astype(np.float32)
    off = (rng.randn(n, dg * k * k * 2, oh, ow) * 2.5).astype(np.float32)
    wt = rng.randn(cout, cin // groups, k, k).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    mask = rng.rand(n, dg * k * k, oh, ow).astype(np.float32)
    want = _deform_ref(x, off, wt, bias, stride, pad, dil, dg, groups, mask)
    got = TO.deform_conv2d(_t(x), _t(off), _t(wt), _t(bias), stride, pad,
                           dil, dg, groups, _t(mask))
    _close(got, want, tol=1e-5)
    layer = TO.DeformConv2D(cin, cout, k, stride, pad, dil, dg, groups,
                            device='cpu')
    with torch.no_grad():
        layer._layer.weight.copy_(_t(wt))
        layer._layer.bias.copy_(_t(bias))
    _close(layer(_t(x), _t(off), _t(mask)), want, tol=1e-5)


def test_deform_conv2d_gradcheck_float64():
    rng = np.random.RandomState(15)
    x = torch.tensor(rng.randn(1, 4, 5, 5), requires_grad=True)
    off = torch.tensor(rng.rand(1, 2 * 4 * 2, 4, 4) * 2 - 0.7,
                       requires_grad=True)
    w = torch.tensor(rng.randn(4, 2, 2, 2), requires_grad=True)
    b = torch.tensor(rng.randn(4), requires_grad=True)
    m = torch.tensor(rng.rand(1, 2 * 4, 4, 4), requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda *a: TO.deform_conv2d(a[0], a[1], a[2], a[3], 1, 0, 1, 2, 2,
                                    a[4]), (x, off, w, b, m))


def test_jax_deform_conv2d_raises_type_error():
    """The JAX function's reference defect: it cannot be the reference
    while this holds; once it is fixed, hold the port to it."""
    with pytest.raises(TypeError, match='permutation'):
        JO.deform_conv2d(_j(np.zeros((1, 4, 6, 6), np.float32)),
                         _j(np.zeros((1, 18, 4, 4), np.float32)),
                         _j(np.zeros((5, 4, 3, 3), np.float32)))
