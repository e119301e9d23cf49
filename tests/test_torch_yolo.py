"""The port's PP-YOLOv2 (paddle_tpu_torch/vision/models/yolo.py), its
Predictor route and the fluid op table's detection ops against the JAX
package's, as tests/test_yolo.py and tests/test_fluid_interop.py drive
them.

The model is `ppyolov2(num_classes=6, width=8, img_size=64)` built once
in JAX (initializers drawn by numpy, tests/jax_numpy_init.py) and carried
across with load_vision_state: 111 parameters and the batch norms'
statistics, 181 state entries. The JAX forward runs once per mode,
jitted through functional_call. Train mode gives the three raw maps
within 1e-4 of their largest |value|; eval mode decodes (boxes, scores)
within 1e-4 of theirs; postprocess (matrix NMS) on the JAX decode's own
arrays gives the JAX rows. The port's jit.save -> Config /
create_predictor round trip (compiled on the CPU) gives the eager
boxes within 1e-4.

The fluid programs, written as reference-format ProgramDescs with
tests/test_torch_fluid.py's writer: the PP-YOLO tail (yolo_box ->
transpose2 -> multiclass_nms3) and roi_align with RoisNum beside a
box_coder decode, each through both packages' load_fluid_model, within
1e-5 (the kept rows and their count exactly).
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import jax
import numpy as np
import pytest
import torch
import torch._inductor.config as inductor_config

import paddle_tpu as paddle
from paddle_tpu.framework import functional as jfm
from paddle_tpu.inference import fluid_program as jfp
from paddle_tpu.vision.models import yolo as jyolo

from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch.inference import fluid_program as tfp
from paddle_tpu_torch.vision import detection as TD
from paddle_tpu_torch.vision import ops as TO
from paddle_tpu_torch.vision.models import load_vision_state, ppyolov2

import jax_numpy_init
from test_torch_fluid import _feed_fetch, _op, _var, _write_model

M_BOXES = (8 * 8 + 4 * 4 + 2 * 2) * 3


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setattr(inductor_config, 'compile_threads', 1)


@pytest.fixture(scope='module')
def pair():
    """The JAX model (numpy-drawn weights) and the port's, carrying its
    state."""
    with pytest.MonkeyPatch.context() as mp:
        jax_numpy_init.install(mp)
        jm = jyolo.ppyolov2(num_classes=6, width=8, img_size=64)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = ppyolov2(num_classes=6, width=8, img_size=64, device='cpu',
                  seed=1)
    load_vision_state(tm, state)
    return jm, tm, state


def _jax_forward(jm, x, training):
    fn = jax.jit(lambda p, b, a: jfm.functional_call(
        jm, p, b, args=(a,), training=training)[0])
    out = fn(jfm.extract_params(jm), jfm.extract_buffers(jm), x)
    return [np.asarray(o) for o in out]


def _close_scaled(got, want, rel, msg=''):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    scale = max(np.abs(want).max(), 1e-6)
    err = np.abs(got - want).max()
    assert err <= rel * scale, (msg, err, scale)


def _image(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def test_ppyolov2_state_and_train_mode_maps(pair):
    jm, tm, state = pair
    assert sorted(state) == sorted(tm.state_dict())
    assert len(state) == 181 and len(list(tm.parameters())) == 111
    x = _image((1, 3, 64, 64), 0)
    want = _jax_forward(jm, x, True)
    tm.train()
    with torch.no_grad():
        got = tm(torch.tensor(x))
    assert [tuple(o.shape) for o in got] == \
        [(1, 33, 8, 8), (1, 33, 4, 4), (1, 33, 2, 2)]
    for i, (g, w) in enumerate(zip(got, want)):
        _close_scaled(g, w, 1e-4, 'level %d' % i)
    load_vision_state(tm, state)  # train mode moved the statistics


def test_ppyolov2_eval_decode_and_postprocess_match_jax(pair):
    jm, tm, _ = pair
    x = _image((2, 3, 64, 64), 1)
    jboxes, jscores = _jax_forward(jm, x, False)
    tm.eval()
    with torch.no_grad():
        boxes, scores = tm(torch.tensor(x))
    assert tuple(boxes.shape) == (2, M_BOXES, 4)
    assert tuple(scores.shape) == (2, 6, M_BOXES)
    _close_scaled(boxes, jboxes, 1e-4, 'boxes')
    _close_scaled(scores, jscores, 1e-4, 'scores')
    # postprocess on the JAX decode's own arrays
    for keep, most_moved in ((20, 0), (100, 2)):
        want = jax.jit(lambda b, s: [t._data for t in jm.postprocess(
            paddle.Tensor(b), paddle.Tensor(s), keep_top_k=keep)])(
                jboxes, jscores)
        got = tm.postprocess(torch.tensor(jboxes), torch.tensor(jscores),
                             keep_top_k=keep)
        assert tuple(got[0].shape) == (2 * keep, 6)
        assert _tie_moved_rows(got[0].numpy(), np.asarray(want[0]),
                               keep) <= most_moved
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert got[1].dtype == torch.int32


def _tie_moved_rows(got, want, keep, tol=1e-6):
    """Two NMS outputs [B * keep, 6]: scores within tol row by row, and
    the same (label, box) rows in the same order but among rows whose
    scores tie within tol (a run of them is one group; its order, and so
    its rows' places, follow f32 rounding of the decay: the JAX package's
    own eager and jitted matrix_nms part there). Returns how many rows
    such a tie placed."""
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=tol, atol=tol)
    moved = 0
    for g, w in zip(got.reshape(-1, keep, 6), want.reshape(-1, keep, 6)):
        start = 0
        for end in range(1, keep + 1):
            if end < keep and abs(w[end, 1] - w[end - 1, 1]) <= tol:
                continue
            rows_g = g[start:end, [0, 2, 3, 4, 5]]
            rows_w = w[start:end, [0, 2, 3, 4, 5]]
            assert sorted(map(tuple, rows_g)) == sorted(map(tuple, rows_w))
            moved += int((rows_g != rows_w).any(1).sum())
            start = end
    return moved


def test_ppyolov2_through_predictor(pair, tmp_path):
    jm, tm, _ = pair
    tm.eval()
    path = str(tmp_path / 'ppyolov2')
    tjit.save(tm, path)
    config = tinf.Config(path)
    config.disable_gpu()
    pred = tinf.create_predictor(config)
    x = _image((1, 3, 64, 64), 2)
    names = pred.get_input_names()
    pred.get_input_handle(names[0]).copy_from_cpu(x)
    pred.run()
    boxes = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
    assert boxes.shape == (1, M_BOXES, 4)
    with torch.no_grad():
        eager, _ = tm(torch.tensor(x))
    _close_scaled(boxes, eager.numpy(), 1e-4, 'Predictor vs eager')
    _close_scaled(boxes, _jax_forward(jm, x, False)[0], 1e-4,
                  'Predictor vs JAX')
    assert pred.compile_count() == 1


# ---- the fluid op table ------------------------------------------------------

def _yolo_tail_dir(tmp_path, na, cls, h):
    c = na * (5 + cls)
    variables, head, tail = _feed_fetch(['head', 'imgsz'],
                                        ['dets', 'rois_n'])
    variables += [
        _var('head', dims=[-1, c, h, h]),
        _var('imgsz', dims=[-1, 2], dtype=2),       # int32
        _var('boxes', dims=[-1, na * h * h, 4]),
        _var('scores_mc', dims=[-1, na * h * h, cls]),
        _var('scores', dims=[-1, cls, na * h * h]),
        _var('dets', dims=[-1, 6]),
        _var('rois_n', dims=[-1], dtype=2),
    ]
    ops = [
        _op('yolo_box', [('X', ['head']), ('ImgSize', ['imgsz'])],
            [('Boxes', ['boxes']), ('Scores', ['scores_mc'])],
            [('anchors', 3, [10, 13, 16, 30, 33, 23]), ('class_num', 0, cls),
             ('conf_thresh', 1, 0.01), ('downsample_ratio', 0, 32),
             ('clip_bbox', 6, True), ('scale_x_y', 1, 1.0)]),
        _op('transpose2', [('X', ['scores_mc'])], [('Out', ['scores'])],
            [('axis', 3, [0, 2, 1])]),
        _op('multiclass_nms3',
            [('BBoxes', ['boxes']), ('Scores', ['scores'])],
            [('Out', ['dets']), ('NmsRoisNum', ['rois_n'])],
            [('score_threshold', 1, 0.01), ('nms_top_k', 0, 10),
             ('keep_top_k', 0, 5), ('nms_threshold', 1, 0.45),
             ('normalized', 6, True), ('background_label', 0, -1)]),
    ]
    return _write_model(tmp_path, 'yolo_tail', variables, head + ops + tail)


def test_fluid_yolo_tail_matches_jax(tmp_path):
    """The exported PP-YOLO tail through both packages' op tables, and
    against the port's own vision functions."""
    na, cls, h = 3, 4, 4
    d = str(_yolo_tail_dir(tmp_path, na, cls, h))
    rng = np.random.RandomState(8)
    feed = {'head': rng.randn(2, na * (5 + cls), h, h).astype(np.float32),
            'imgsz': np.array([[128, 128], [96, 112]], np.int32)}
    want = jfp.load_fluid_model(d).run(feed)
    got = tfp.load_fluid_model(d, device='cpu').run(feed)
    np.testing.assert_array_equal(got[0][:, 0], np.asarray(want[0])[:, 0])
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    boxes, scores = TO.yolo_box(
        torch.tensor(feed['head']), torch.tensor(feed['imgsz']),
        anchors=[10, 13, 16, 30, 33, 23], class_num=cls, conf_thresh=0.01,
        downsample_ratio=32)
    out, rois = TD.multiclass_nms3(
        boxes, scores.transpose(1, 2), score_threshold=0.01, nms_top_k=10,
        keep_top_k=5, nms_threshold=0.45, background_label=-1)
    np.testing.assert_allclose(got[0], out.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[1], rois.numpy())


def test_fluid_roi_align_and_box_coder_match_jax(tmp_path):
    variables, head, tail = _feed_fetch(
        ['feat', 'rois', 'rois_num', 'prior', 'deltas'],
        ['pooled', 'decoded'])
    variables += [_var('feat', dims=[-1, 3, 8, 8]),
                  _var('rois', dims=[-1, 4]),
                  _var('rois_num', dims=[-1], dtype=2),
                  _var('prior', dims=[-1, 4]),
                  _var('deltas', dims=[-1, 5, 4]),
                  _var('pooled', dims=[-1, 3, 2, 2]),
                  _var('decoded', dims=[-1, 5, 4])]
    ops = [
        _op('roi_align',
            [('X', ['feat']), ('ROIs', ['rois']), ('RoisNum', ['rois_num'])],
            [('Out', ['pooled'])],
            [('pooled_height', 0, 2), ('pooled_width', 0, 2),
             ('spatial_scale', 1, 0.5), ('sampling_ratio', 0, 2),
             ('aligned', 6, True)]),
        _op('box_coder', [('PriorBox', ['prior']),
                          ('TargetBox', ['deltas'])],
            [('OutputBox', ['decoded'])],
            [('code_type', 2, 'decode_center_size'),
             ('box_normalized', 6, False), ('axis', 0, 0),
             ('variance', 4, [0.1, 0.1, 0.2, 0.2])]),
    ]
    d = str(_write_model(tmp_path, 'rcnn', variables, head + ops + tail))
    rng = np.random.RandomState(9)
    rois = np.abs(rng.randn(4, 4)).astype(np.float32) * 4
    rois[:, 2:] += rois[:, :2] + 2
    prior = np.abs(rng.randn(5, 4)).astype(np.float32) * 8
    prior[:, 2:] += prior[:, :2] + 4
    feed = {'feat': rng.randn(2, 3, 8, 8).astype(np.float32), 'rois': rois,
            'rois_num': np.array([3, 1], np.int32), 'prior': prior,
            'deltas': (rng.randn(3, 5, 4) * 0.3).astype(np.float32)}
    want = jfp.load_fluid_model(d).run(feed)
    got = tfp.load_fluid_model(d, device='cpu').run(feed)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5)
