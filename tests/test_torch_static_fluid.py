"""The port's fluid-era static.nn builders (paddle_tpu_torch/static/nn.py)
against the JAX package's on the same seeded numpy inputs: data_norm,
bilinear_tensor_product, rank_loss, bpr_loss, center_loss (the loss and
the centres' eager update), cvm, pad_constant_like, im2sequence (F.unfold's
channel order against XLA's conv_general_dilated_patches), row_conv,
sample_logits, linear_chain_crf and crf_decoding.

Outputs and the grads of sum(out * cotangent) within 1e-5; the defaults
the JAX builders draw from numpy (bilinear_tensor_product's weight,
linear_chain_crf's transition, sample_logits' negatives) are drawn alike,
so those outputs match too. nce and sparse_embedding refuse with the JAX
package's messages.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.static.nn as jsnn

import paddle_tpu_torch.static.nn as tsnn

from test_torch_loss_functions import _check, _close, _f32

R = np.random.RandomState(7)
X46 = _f32(R.randn(4, 6))
Y45 = _f32(R.randn(4, 5))
LAB41 = _f32(R.randint(0, 2, (4, 1)))
CLS4 = R.randint(0, 6, (4, 1)).astype(np.int64)
SHOWCLICK = _f32(R.uniform(0, 5, (4, 2)))
IMG = _f32(R.randn(2, 3, 6, 7))
SEQ = _f32(R.randn(2, 5, 4))
EM = _f32(R.randn(3, 5, 4))
CRF_LAB = R.randint(0, 4, (3, 5)).astype(np.int64)
CRF_LEN = np.array([5, 3, 1], np.int64)
TRANS = _f32(R.randn(6, 4) * 0.3)

CASES = [
    ('data-norm', lambda S, T: lambda x: S.data_norm(x), [X46]),
    ('bilinear-tensor-product', lambda S, T: lambda x, y:
     S.bilinear_tensor_product(x, y, 3), [X46, Y45]),
    ('rank-loss', lambda S, T: lambda lo, ro: S.rank_loss(T(LAB41), lo, ro),
     [X46[:, :1], Y45[:, :1]]),
    ('bpr-loss', lambda S, T: lambda x: S.bpr_loss(x, T(CLS4)), [X46]),
    ('center-loss', lambda S, T: lambda x: S.center_loss(
        x, T(CLS4), 6, 0.5, update_center=False)[0], [X46]),
    ('cvm', lambda S, T: lambda x, c: S.cvm(x, c), [X46, SHOWCLICK]),
    ('cvm-strip', lambda S, T: lambda x: S.cvm(x, T(SHOWCLICK), False),
     [X46]),
    ('pad-constant-like', lambda S, T: lambda y: S.pad_constant_like(
        T(np.zeros((5, 7, 3), np.float32)), y, 1.5), [_f32(R.randn(3, 7, 2))]),
    ('im2sequence', lambda S, T: lambda x: S.im2sequence(x, 3), [IMG]),
    ('im2sequence-stride-pad', lambda S, T: lambda x: S.im2sequence(
        x, [2, 3], [2, 1], 1), [IMG]),
    ('im2sequence-4-pads', lambda S, T: lambda x: S.im2sequence(
        x, 2, 2, [1, 0, 2, 1]), [IMG]),
    ('row-conv', lambda S, T: lambda x: S.row_conv(x, 2), [SEQ]),
    ('row-conv-act', lambda S, T: lambda x: S.row_conv(x, 1, act='relu'),
     [SEQ]),
    ('linear-chain-crf', lambda S, T: lambda e, t: S.linear_chain_crf(
        e, T(CRF_LAB), length=T(CRF_LEN), transition=t)[0], [EM, TRANS]),
    ('linear-chain-crf-defaults', lambda S, T: lambda e: S.linear_chain_crf(
        e, T(CRF_LAB))[0], [EM]),
]


@pytest.mark.parametrize('case,args', [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_fluid_builder_matches_jax(case, args):
    _check(lambda F, nn, T: case(jsnn if F.__name__.startswith(
        'paddle_tpu.') else tsnn, T), args)


def test_center_loss_moves_the_centres_as_jax():
    centers = _f32(R.randn(6, 6))
    jl, jc = jsnn.center_loss(paddle.to_tensor(X46), paddle.to_tensor(CLS4),
                              6, 0.3, centers=paddle.to_tensor(centers))
    tc_in = torch.tensor(centers)
    tl, tc = tsnn.center_loss(torch.tensor(X46), torch.tensor(CLS4), 6, 0.3,
                              centers=tc_in)
    assert tc is tc_in        # updated in place, as the JAX Tensor is
    _close(tl, jl.numpy())
    _close(tc, jc.numpy())
    # from no centres: zeros, then the update
    _, tc = tsnn.center_loss(torch.tensor(X46), torch.tensor(CLS4), 6, 0.5)
    _, jc = jsnn.center_loss(paddle.to_tensor(X46), paddle.to_tensor(CLS4),
                             6, 0.5)
    _close(tc, jc.numpy())


@pytest.mark.parametrize('with_label', [False, True])
def test_crf_decoding_matches_jax(with_label):
    kw = dict(length=CRF_LEN, label=CRF_LAB if with_label else None)
    want = jsnn.crf_decoding(paddle.to_tensor(EM), paddle.to_tensor(TRANS),
                             **{k: paddle.to_tensor(v) for k, v in kw.items()
                                if v is not None}).numpy()
    got = tsnn.crf_decoding(torch.tensor(EM), torch.tensor(TRANS),
                            **{k: torch.tensor(v) for k, v in kw.items()
                               if v is not None})
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('label,kw', [
    (CLS4, dict(num_samples=5, seed=3)),
    (np.array([[0, 5], [1, 2], [3, 3], [4, 0]]),
     dict(num_samples=4, num_true=2, seed=11,
          remove_accidental_hits=False))])
def test_sample_logits_matches_jax(label, kw):
    # the JAX builder samples with numpy on its traced arrays, so it runs
    # eagerly (its tape takes the gradient), not under jax.jit
    cot = _f32(np.random.RandomState(0).randn(4, kw.get('num_true', 1) +
                                              kw['num_samples']))
    jx = paddle.to_tensor(X46, stop_gradient=False)
    jout = jsnn.sample_logits(jx, paddle.to_tensor(label), **kw)[0]
    (jout * paddle.to_tensor(cot)).sum().backward()
    tx = torch.tensor(X46, requires_grad=True)
    tout = tsnn.sample_logits(tx, torch.tensor(label), **kw)[0]
    (tout * torch.tensor(cot)).sum().backward()
    _close(tout, jout.numpy())
    _close(tx.grad, jx.grad.numpy())


def test_sample_logits_labels_and_refusals():
    _, lab = tsnn.sample_logits(torch.tensor(X46), torch.tensor(CLS4), 3,
                                seed=1)
    assert lab.tolist() == [[0]] * 4
    for name, args in (('nce', (None, None, 10)),
                       ('sparse_embedding', (None, [10, 4]))):
        with pytest.raises(NotImplementedError) as jerr:
            getattr(jsnn, name)(*args)
        with pytest.raises(NotImplementedError) as terr:
            getattr(tsnn, name)(*args)
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(NotImplementedError, match='ROADMAP Queue 1 item'):
        tsnn.sequence_pool(None)
