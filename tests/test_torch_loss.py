"""The port's losses (paddle_tpu_torch/nn/functional/loss.py and
ops/fused_ce.py) against the JAX package's: the fused LM-head
cross-entropy and its gradients against linear_cross_entropy_arrays
through jax.vjp, and cross_entropy against the JAX functional."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.ops import fused_ce as jfce
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import fused_ce as tfce

ROWS, D, VOCAB = 37, 16, 50


def _inputs(seed=0, ignore=-100):
    rng = np.random.RandomState(seed)
    x = rng.randn(ROWS, D).astype(np.float32)
    w = (rng.randn(D, VOCAB) * 0.3).astype(np.float32)
    bias = (rng.randn(VOCAB) * 0.1).astype(np.float32)
    labels = rng.randint(0, VOCAB, ROWS)
    labels[[3, 17, 30]] = ignore
    g = np.float32(1.7)
    return x, w, bias, labels, g


def _leaf(a):
    return torch.tensor(a).requires_grad_(True)


# f32 logits and sums on both sides, in another order: ~1e-6 relative
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('with_bias', [True, False])
@pytest.mark.parametrize('chunk', [8, 4096])
def test_fused_ce_loss_and_grads_match_jax(with_bias, chunk):
    # 37 rows are not a multiple of the 8-row chunk; rows 3, 17 and 30 are
    # ignored
    x, w, bias, labels, g = _inputs()
    b = bias if with_bias else None
    jargs = [jnp.asarray(x), jnp.asarray(w)] + (
        [jnp.asarray(b)] if with_bias else [])

    def jfn(*a):
        return jfce.linear_cross_entropy_arrays(
            a[0], a[1], jnp.asarray(labels, jnp.int32),
            a[2] if with_bias else None, -100, chunk)

    want, vjp = jax.vjp(jfn, *jargs)
    want_grads = vjp(jnp.asarray(g))
    targs = [_leaf(x), _leaf(w)] + ([_leaf(b)] if with_bias else [])
    got = tfce.linear_cross_entropy_arrays(
        targs[0], targs[1], torch.from_numpy(labels),
        targs[2] if with_bias else None, -100, chunk)
    got_grads = torch.autograd.grad(got, targs, torch.tensor(g))
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    for gt, wt in zip(got_grads, want_grads):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), **TOL)


def test_fused_ce_chunk_plan_bounds_the_chunk_count():
    assert tfce._chunk_plan(37, 8) == jfce._chunk_plan(37, 8)[:2]
    assert tfce._chunk_plan(16384, 4096) == (4096, 4)
    assert tfce._chunk_plan(100000, 16) == jfce._chunk_plan(100000, 16)[:2]
    assert tfce._chunk_plan(10, 4096) == (10, 1)


def test_linear_cross_entropy_tied_layout_matches_jax():
    # the tied-embedding layout: weight [vocab, d], transpose_weight=True,
    # over [b, n, d] activations
    x, w, _, labels, _ = _inputs(seed=1)
    emb = np.ascontiguousarray(w.T)
    want, vjp = jax.vjp(
        lambda a, e: jfce.linear_cross_entropy_arrays(
            a, e.T, jnp.asarray(labels, jnp.int32), None, -100, 8),
        jnp.asarray(x), jnp.asarray(emb))
    want_dx, want_de = vjp(jnp.ones((), jnp.float32))
    tx, te = _leaf(x.reshape(1, ROWS, D)), _leaf(emb)
    got = TF.linear_cross_entropy(tx, te, torch.from_numpy(labels[None]),
                                  transpose_weight=True, chunk_rows=8)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(tx.grad.numpy()[0], np.asarray(want_dx), **TOL)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(want_de), **TOL)


def test_fused_ce_bf16_returns_bf16_close_to_f32():
    # bf16 logits tiles (8 bits) against the f32 computation: the loss
    # within 1 %, and the loss in x's dtype as in the JAX package
    x, w, bias, labels, _ = _inputs(seed=2)
    lo = tfce.linear_cross_entropy_arrays(
        torch.tensor(x).bfloat16(), torch.tensor(w).bfloat16(),
        torch.from_numpy(labels), torch.tensor(bias).bfloat16(), -100, 8)
    hi = tfce.linear_cross_entropy_arrays(
        torch.tensor(x), torch.tensor(w), torch.from_numpy(labels),
        torch.tensor(bias), -100, 8)
    assert lo.dtype == torch.bfloat16
    assert abs(lo.float().item() - hi.item()) <= 0.01 * hi.item()


@pytest.mark.parametrize('reduction', ['mean', 'sum', 'none'])
def test_cross_entropy_matches_jax(reduction):
    x, _, _, labels, _ = _inputs(seed=3)
    logits = x @ np.random.RandomState(4).randn(D, VOCAB).astype(np.float32)
    jx = paddle.to_tensor(logits, stop_gradient=False)
    want = JF.cross_entropy(jx, paddle.to_tensor(labels), reduction=reduction)
    want.sum().backward() if reduction == 'none' else want.backward()
    tx = _leaf(logits)
    got = TF.cross_entropy(tx, torch.from_numpy(labels), reduction=reduction)
    (got.sum() if reduction == 'none' else got).backward()
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), **TOL)


def test_cross_entropy_squeezes_label_dim_and_keeps_bf16():
    logits = torch.randn(6, 9).bfloat16()
    lab = torch.tensor([[1], [2], [3], [-100], [4], [5]])
    out = TF.cross_entropy(logits, lab)
    assert out.dtype == torch.bfloat16 and out.dim() == 0
    same = TF.cross_entropy(logits, lab[:, 0])
    assert torch.equal(out, same)


@pytest.mark.parametrize('kwargs', [{'soft_label': True},
                                    {'weight': torch.ones(9)},
                                    {'use_softmax': False}])
def test_cross_entropy_unported_options_raise(kwargs):
    with pytest.raises(NotImplementedError, match='not ported'):
        TF.cross_entropy(torch.randn(6, 9), torch.zeros(6).long(), **kwargs)
