"""The port's extension functionals (paddle_tpu_torch/nn/functional/
extension.py) and HSigmoidLoss against the JAX package's on the same
seeded numpy inputs.

The gathers (gather_tree, sequence_mask, temporal_shift, diag_embed,
grid_sample 'nearest') are compared exactly; the rest within 1e-5, their
gradients by jax.grad of sum(out * cotangent) against autograd. grid_sample
keeps the JAX package's modes: 'reflection' samples as 'zeros', 'nearest'
rounds half to even. hsigmoid_loss returns the batch mean as [1].
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF

import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.text.models.gpt import load_paddle_tpu_state

from jax_numpy_init import numpy_init  # noqa: F401
from test_torch_loss_functions import _check, _close, _f32


def test_gather_tree_matches_jax():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 9, (5, 3, 4)).astype(np.int64)
    parents = rng.randint(0, 4, (5, 3, 4)).astype(np.int64)
    want = JF.gather_tree(paddle.to_tensor(ids),
                          paddle.to_tensor(parents)).numpy()
    got = TF.gather_tree(torch.tensor(ids), torch.tensor(parents))
    np.testing.assert_array_equal(got.numpy(), want)
    # the reference op's crossed beams (tests/test_op_tranche_r3b.py)
    ids = torch.tensor([[[1, 2]], [[3, 4]], [[5, 6]]])
    parents = torch.tensor([[[0, 0]], [[1, 1]], [[1, 0]]])
    assert TF.gather_tree(ids, parents)[:, 0, 0].tolist() == [2, 4, 5]


@pytest.mark.parametrize('maxlen,dtype', [(None, 'int64'), (7, 'float32'),
                                          (3, 'bool')])
def test_sequence_mask_matches_jax(maxlen, dtype):
    lens = np.array([[0, 4], [5, 2]], np.int64)
    want = JF.sequence_mask(paddle.to_tensor(lens), maxlen, dtype).numpy()
    got = TF.sequence_mask(torch.tensor(lens), maxlen, dtype)
    assert str(got.dtype).split('.')[-1] == dtype
    np.testing.assert_array_equal(got.numpy(), want)


R = np.random.RandomState(1)
VIDEO = _f32(R.randn(6, 8, 3, 2))
DIAG = _f32(R.randn(2, 3, 4))
THETA = _f32(R.randn(2, 2, 3) * 0.5 + np.array([[1, 0, 0], [0, 1, 0]]))
IMG = _f32(R.randn(2, 3, 5, 6))
# sample points inside, on the border and past it
GRID = _f32(R.uniform(-1.3, 1.3, (2, 4, 7, 2)))
NEAR_GRID = _f32(np.round(R.uniform(-1.4, 1.4, (2, 4, 7, 2)) * 4) / 4)
HS_X = _f32(R.randn(5, 6))
HS_W7 = _f32(R.randn(7, 6) * 0.5)
HS_B7 = _f32(R.randn(7) * 0.1)

CASES = [
    ('temporal-shift', lambda F, T: lambda x: F.temporal_shift(x, 3),
     [VIDEO]),
    ('temporal-shift-ratio', lambda F, T: lambda x: F.temporal_shift(
        x, 2, 0.3), [VIDEO]),
    ('diag-embed', lambda F, T: lambda x: F.diag_embed(x), [DIAG]),
    ('diag-embed-offset', lambda F, T: lambda x: F.diag_embed(
        x, 2, 0, 2), [DIAG]),
    ('diag-embed-neg-swapped', lambda F, T: lambda x: F.diag_embed(
        x, -1, 3, 1), [DIAG]),
    ('affine-grid', lambda F, T: lambda t: F.affine_grid(t, [2, 3, 4, 5]),
     [THETA]),
    ('affine-grid-unaligned', lambda F, T: lambda t: F.affine_grid(
        t, [2, 3, 5, 3], align_corners=False), [THETA]),
    ('grid-bilinear-zeros', lambda F, T: lambda x, g: F.grid_sample(x, g),
     [IMG, GRID]),
    ('grid-bilinear-border-unaligned', lambda F, T: lambda x, g:
     F.grid_sample(x, g, padding_mode='border', align_corners=False),
     [IMG, GRID]),
    ('grid-bilinear-reflection', lambda F, T: lambda x, g:
     F.grid_sample(x, g, padding_mode='reflection'), [IMG, GRID]),
    ('grid-nearest', lambda F, T: lambda x: F.grid_sample(
        x, T(NEAR_GRID), mode='nearest'), [IMG]),
    ('grid-nearest-border-unaligned', lambda F, T: lambda x: F.grid_sample(
        x, T(NEAR_GRID), mode='nearest', padding_mode='border',
        align_corners=False), [IMG]),
    ('hsigmoid-default-tree', lambda F, T: lambda x, w, b: F.hsigmoid_loss(
        x, T(np.array([0, 3, 7, 5, 2])), 8, w, b), [HS_X, HS_W7, HS_B7]),
    ('hsigmoid-odd-classes', lambda F, T: lambda x, w: F.hsigmoid_loss(
        x, T(np.array([[0], [4], [5], [1], [2]])), 6, w[:5]),
     [HS_X, HS_W7]),
    ('hsigmoid-custom', lambda F, T: lambda x, w, b: F.hsigmoid_loss(
        x, T(np.array([0, 2, 1, 2, 0])), 3, w, b,
        path_table=np.array([[0, 1, -1], [0, 2, 5], [3, -1, -1]]),
        path_code=np.array([[1, 0, -1], [0, 1, 1], [1, -1, -1]])),
     [HS_X, HS_W7, HS_B7]),
]


@pytest.mark.parametrize('case,args', [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_extension_matches_jax_forward_and_grads(case, args):
    _check(lambda F, nn, T: case(F, T), args)


def test_grid_sample_keeps_the_jax_modes():
    x, g = torch.tensor(IMG), torch.tensor(GRID)
    _close(TF.grid_sample(x, g, padding_mode='reflection'),
           TF.grid_sample(x, g))
    # 'nearest' rounds half to even: 0.5 of a pixel lands on pixel 0
    half = torch.tensor([[[[-1.0 + 1.0 / 5, -1.0]]]])      # x = 0.5 px
    out = TF.grid_sample(torch.arange(6.0).reshape(1, 1, 1, 6),
                         half.expand(1, 1, 1, 2), mode='nearest')
    assert out.flatten().tolist() == [0.0]


def test_hsigmoid_layer_carried_across(numpy_init):
    jl = jnn.HSigmoidLoss(6, 8)
    tl = tnn.HSigmoidLoss(6, 8, device='cpu')
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    assert set(state) == {'weight', 'bias'} and state['weight'].shape == \
        (7, 6)
    load_paddle_tpu_state(tl, state)
    lab = np.array([0, 3, 7, 5, 2])
    want = jl(paddle.to_tensor(HS_X), paddle.to_tensor(lab)).numpy()
    got = tl(torch.tensor(HS_X), torch.tensor(lab))
    assert tuple(got.shape) == (1,)
    _close(got, want)
    assert tuple(tnn.HSigmoidLoss(6, 8, is_custom=True,
                                  device='cpu').weight.shape) == (8, 6)
