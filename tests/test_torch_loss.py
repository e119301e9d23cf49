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


@pytest.mark.parametrize('with_bias', [True, False])
def test_fused_ce_ops_opcheck_and_compiled_grads_match_jax(with_bias):
    """The fused CE as custom operators (paddle_tpu_torch::linear_ce_fwd /
    linear_ce_bwd): opcheck, and the loss and gradients of the compiled
    call (torch.compile with fullgraph) against the JAX package's."""
    x, w, bias, labels, g = _inputs(seed=1)
    b = bias if with_bias else None
    targs = [_leaf(x), _leaf(w)] + ([_leaf(b)] if with_bias else [])
    tlabels = torch.from_numpy(labels)
    torch.library.opcheck(tfce.linear_ce_fwd_op,
                          (targs[0], targs[1], tlabels,
                           targs[2] if with_bias else None, -100, 8))
    compiled = torch.compile(
        lambda *a: tfce.linear_cross_entropy_arrays(
            a[0], a[1], tlabels, a[2] if with_bias else None, -100, 8),
        fullgraph=True, backend='aot_eager')
    got = compiled(*targs)
    got_grads = torch.autograd.grad(got, targs, torch.tensor(g))
    jargs = [jnp.asarray(x), jnp.asarray(w)] + (
        [jnp.asarray(b)] if with_bias else [])
    want, vjp = jax.vjp(lambda *a: jfce.linear_cross_entropy_arrays(
        a[0], a[1], jnp.asarray(labels, jnp.int32),
        a[2] if with_bias else None, -100, 8), *jargs)
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    for gt, wt in zip(got_grads, vjp(jnp.asarray(g))):
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


def _ce_pair(kwargs, logits, label, reduction='mean'):
    """cross_entropy's loss and input grad in both packages; kwargs values
    that are numpy arrays become each package's tensor."""
    jkw = {k: paddle.to_tensor(v) if isinstance(v, np.ndarray) else v
           for k, v in kwargs.items()}
    tkw = {k: torch.tensor(v) if isinstance(v, np.ndarray) else v
           for k, v in kwargs.items()}
    jx = paddle.to_tensor(logits, stop_gradient=False)
    want = JF.cross_entropy(jx, paddle.to_tensor(label),
                            reduction=reduction, **jkw)
    want.sum().backward() if reduction == 'none' else want.backward()
    tx = _leaf(logits)
    got = TF.cross_entropy(tx, torch.from_numpy(label), reduction=reduction,
                           **tkw)
    (got.sum() if reduction == 'none' else got).backward()
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), **TOL)


def _soft(rng, shape, axis=-1):
    p = rng.rand(*shape).astype(np.float32)
    return p / p.sum(axis=axis, keepdims=True)


# These options raised NotImplementedError until the training slice ported
# them; each case now holds the port to the JAX functional with it.
@pytest.mark.parametrize('kwargs', [{'soft_label': True},
                                    {'weight': np.linspace(
                                        0.5, 2.0, 9).astype(np.float32)},
                                    {'use_softmax': False}])
def test_cross_entropy_unported_options_raise(kwargs):
    rng = np.random.RandomState(11)
    logits = rng.randn(6, 9).astype(np.float32)
    if kwargs.get('soft_label'):
        label = _soft(rng, (6, 9))
    else:
        label = rng.randint(0, 9, 6)
        label[2] = -100
    if kwargs.get('use_softmax') is False:
        logits = _soft(rng, (6, 9))  # probabilities in, log taken as is
    _ce_pair(kwargs, logits, label)


@pytest.mark.parametrize('reduction', ['mean', 'sum', 'none'])
@pytest.mark.parametrize('case', ['soft_nosoftmax', 'weight_ignore',
                                  'axis1', 'axis1_nosoftmax', 'soft_axis1',
                                  'weight_label_dim'])
def test_cross_entropy_options_match_jax(case, reduction):
    rng = np.random.RandomState(12)
    w = rng.rand(5).astype(np.float32) + 0.5
    if case == 'soft_nosoftmax':
        _ce_pair({'soft_label': True, 'use_softmax': False},
                 _soft(rng, (7, 5)), _soft(rng, (7, 5)), reduction)
    elif case == 'weight_ignore':
        label = rng.randint(0, 5, 7)
        label[[1, 4]] = -100
        _ce_pair({'weight': w}, rng.randn(7, 5).astype(np.float32), label,
                 reduction)
    elif case == 'axis1':
        # logits [B, C, N] against labels [B, N]
        _ce_pair({'axis': 1}, rng.randn(2, 5, 3).astype(np.float32),
                 rng.randint(0, 5, (2, 3)), reduction)
    elif case == 'axis1_nosoftmax':
        _ce_pair({'axis': 1, 'use_softmax': False},
                 _soft(rng, (2, 5, 3), axis=1), rng.randint(0, 5, (2, 3)),
                 reduction)
    elif case == 'soft_axis1':
        _ce_pair({'soft_label': True, 'axis': 1},
                 rng.randn(2, 5, 3).astype(np.float32),
                 _soft(rng, (2, 5, 3), axis=1), reduction)
    else:
        label = rng.randint(0, 5, (7, 1))
        label[3] = -100
        _ce_pair({'weight': w, 'ignore_index': -100},
                 rng.randn(7, 5).astype(np.float32), label, reduction)


def test_cross_entropy_loss_layer_matches_jax():
    rng = np.random.RandomState(13)
    logits = rng.randn(6, 5).astype(np.float32)
    label = rng.randint(0, 5, 6)
    w = rng.rand(5).astype(np.float32) + 0.5
    want = paddle.nn.CrossEntropyLoss(weight=paddle.to_tensor(w),
                                      reduction='sum')(
        paddle.to_tensor(logits), paddle.to_tensor(label))
    from paddle_tpu_torch.nn import CrossEntropyLoss
    got = CrossEntropyLoss(weight=torch.tensor(w), reduction='sum')(
        torch.tensor(logits), torch.from_numpy(label))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
