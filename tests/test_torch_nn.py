"""The port's nn functions and layers (paddle_tpu_torch/nn) against the JAX
package's, on the same numpy inputs."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.nn.functional.attention import _sdpa_ref as j_sdpa_ref
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.framework import device as tdevice
from paddle_tpu_torch.framework import dtype as tdtype
from paddle_tpu_torch.framework import random as trandom
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.functional.attention import _sdpa_ref as t_sdpa_ref
from paddle_tpu_torch.ops import flash_attention as tfa


@pytest.fixture(autouse=True)
def _interpret_strict(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_FLASH_INTERPRET', '1')
    monkeypatch.setenv('PADDLE_TPU_FLASH_STRICT', '1')


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _j(x):
    return paddle.to_tensor(x)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t.numpy())


@pytest.mark.parametrize('bias', [False, True])
def test_linear(bias):
    x, w, b = _rand(2, 5, 8), _rand(8, 6, seed=1), _rand(6, seed=2)
    got = TF.linear(torch.from_numpy(x), torch.from_numpy(w),
                    torch.from_numpy(b) if bias else None)
    want = JF.linear(_j(x), _j(w), _j(b) if bias else None)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_embedding():
    w = _rand(10, 4)
    ids = np.array([[0, 3, 9], [3, 1, 2]])
    got = TF.embedding(torch.from_numpy(ids), torch.from_numpy(w))
    want = JF.embedding(_j(ids), _j(w))
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize('approximate', [False, True])
def test_gelu(approximate):
    x = _rand(4, 33) * 3
    got = TF.gelu(torch.from_numpy(x), approximate=approximate)
    want = JF.gelu(_j(x), approximate=approximate)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)


def test_layer_norm():
    x, w, b = _rand(2, 3, 16) * 2 + 1, _rand(16, seed=1), _rand(16, seed=2)
    got = TF.layer_norm(torch.from_numpy(x), 16, torch.from_numpy(w),
                        torch.from_numpy(b), 1e-5)
    want = JF.layer_norm(_j(x), 16, _j(w), _j(b), 1e-5)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_rms_norm_layer():
    x, w = _rand(2, 3, 16), _rand(16, seed=1)
    jl = paddle.nn.RMSNorm(16, epsilon=1e-6)
    jl.weight.set_value(jnp.asarray(w))
    tl = tnn.RMSNorm(16, epsilon=1e-6, device='cpu')
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w))
    np.testing.assert_allclose(_np(tl(torch.from_numpy(x)).detach()),
                               _np(jl(_j(x))), rtol=1e-5, atol=1e-5)


def test_layers_keep_paddle_names_and_layouts():
    lin = tnn.Linear(8, 3, device='cpu', generator=trandom.seed(0))
    assert dict((k, tuple(v.shape)) for k, v in lin.state_dict().items()) \
        == {'weight': (8, 3), 'bias': (3,)}
    assert float(lin.bias.detach().abs().max()) == 0.0
    ln = tnn.LayerNorm(8, device='cpu')
    assert float(ln.weight.min()) == 1.0 and float(ln.bias.abs().max()) == 0
    emb = tnn.Embedding(5, 4, device='cpu', dtype='bfloat16')
    assert emb.weight.shape == (5, 4) and emb.weight.dtype == torch.bfloat16
    x = torch.from_numpy(_rand(2, 8))
    np.testing.assert_allclose(lin(x).detach().numpy(),
                               (x @ lin.weight + lin.bias).detach().numpy())


def test_xavier_normal_scale_and_seed():
    init = tnn.initializer.XavierNormal()
    a = init([400, 600], generator=trandom.seed(7))
    b = init([400, 600], generator=trandom.seed(7))
    assert torch.equal(a, b)
    assert abs(float(a.std()) - np.sqrt(2.0 / 1000)) < 1e-3
    assert tnn.initializer.Constant(2.5)([3], 'bfloat16').dtype == \
        torch.bfloat16


def test_dropout_is_eval_mode_only():
    # the name dates from slice 1, when training-mode dropout raised; it is
    # the identity in eval mode and at p = 0, and drops in training mode
    x = torch.ones(4, 3)
    d = tnn.Dropout(0.25)
    d.eval()
    assert d(x) is x
    assert TF.dropout(x, p=0.0, training=True) is x
    assert TF.dropout(x, p=0.5, training=False) is x
    d.train()
    d.generator = torch.Generator().manual_seed(0)
    y = d(x)
    vals = np.unique(y.numpy())
    assert all(v == 0 or np.isclose(v, 1.0 / 0.75, rtol=1e-6) for v in vals)
    q = torch.zeros(1, 4, 2, 64)
    out = TF.scaled_dot_product_attention(q, q, q, dropout_p=0.1)
    assert out.shape == q.shape


@pytest.mark.parametrize('p', [0.1, 0.5])
def test_dropout_keep_rate_and_scale(p):
    # keep rate 1 - p within 5 standard deviations over 200k draws; kept
    # values scaled by exactly 1 / (1 - p); the same generator seed gives
    # the same mask; bf16 stays bf16
    x = torch.ones(200, 1000)
    y = TF.dropout(x, p=p, generator=torch.Generator().manual_seed(1))
    kept = (y != 0).float().mean().item()
    sd = np.sqrt(p * (1 - p) / x.numel())
    assert abs(kept - (1 - p)) < 5 * sd
    np.testing.assert_allclose(y[y != 0].numpy(), 1.0 / (1 - p), rtol=1e-6)
    again = TF.dropout(x, p=p, generator=torch.Generator().manual_seed(1))
    assert torch.equal(y, again)
    assert TF.dropout(x.bfloat16(), p=p).dtype == torch.bfloat16
    assert torch.equal(TF.dropout(x, p=1.0), torch.zeros_like(x))


def test_dropout_backward_reuses_the_forward_mask():
    x = torch.randn(64, 32, requires_grad=True)
    y = TF.dropout(x, p=0.3, generator=torch.Generator().manual_seed(2))
    y.sum().backward()
    mask = (y != 0).float()
    np.testing.assert_allclose(x.grad.numpy(), (mask / 0.7).numpy(),
                               rtol=1e-6)


def test_attention_dropout_routes_off_flash():
    # dropout on the probabilities keeps a 512-token call off flash, as in
    # the JAX package; eval mode (training=False) drops nothing
    q, k, v = (torch.from_numpy(_rand(1, 512, 2, 64, seed=s)) for s in
               range(3))
    before = tfa.counts['flash']
    g = torch.Generator().manual_seed(3)
    out = TF.scaled_dot_product_attention(q, k, v, dropout_p=0.2,
                                          is_causal=True, generator=g)
    assert tfa.counts['flash'] == before
    plain = t_sdpa_ref(q, k, v, None, True, 0.125)
    assert not torch.allclose(out, plain)
    evald = TF.scaled_dot_product_attention(q, k, v, dropout_p=0.2,
                                            is_causal=True, training=False)
    assert tfa.counts['flash'] == before + 1
    np.testing.assert_allclose(evald.numpy(), plain.numpy(), rtol=2e-5,
                               atol=2e-5)
    # the same generator state gives the same probabilities' mask
    again = TF.scaled_dot_product_attention(
        q, k, v, dropout_p=0.2, is_causal=True,
        generator=torch.Generator().manual_seed(3))
    assert torch.equal(out, again)


@pytest.mark.parametrize('n,m', [(16, 16), (1, 24), (5, 24)])
def test_sdpa_ref_causal_bottom_right(n, m):
    q, k, v = _rand(2, n, 3, 64), _rand(2, m, 3, 64, seed=1), \
        _rand(2, m, 3, 64, seed=2)
    got = t_sdpa_ref(*(torch.from_numpy(a) for a in (q, k, v)), None, True,
                     0.125)
    want = j_sdpa_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                      0.0, True, 0.125)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_sdpa_ref_additive_mask():
    n, m = 4, 12
    q, k, v = _rand(2, n, 2, 64), _rand(2, m, 2, 64, seed=1), \
        _rand(2, m, 2, 64, seed=2)
    allow = (3 + np.arange(n))[:, None] >= np.arange(m)[None, :]
    mask = np.where(allow, 0.0, -1e9).astype(np.float32)[None, None]
    got = t_sdpa_ref(*(torch.from_numpy(a) for a in (q, k, v, mask)), False,
                     0.125)
    want = j_sdpa_ref(*(jnp.asarray(a) for a in (q, k, v, mask)), 0.0,
                      False, 0.125)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize('n,masked,flash', [(512, False, True),
                                            (512, True, False),
                                            (256, False, False)])
def test_sdpa_routing(n, masked, flash):
    q, k, v = (torch.from_numpy(_rand(1, n, 2, 64, seed=s)) for s in range(3))
    mask = torch.zeros(1, 1, n, n) if masked else None
    before = tfa.counts['flash']
    out = TF.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          is_causal=True)
    assert tfa.counts['flash'] == before + int(flash)
    want = JF.scaled_dot_product_attention(
        _j(q.numpy()), _j(k.numpy()), _j(v.numpy()),
        attn_mask=_j(mask.numpy()) if masked else None, is_causal=True)
    np.testing.assert_allclose(_np(out), _np(want), rtol=2e-5, atol=2e-5)


def test_dtype_names():
    assert tdtype.to_torch_dtype('bfloat16') is torch.bfloat16
    assert tdtype.to_torch_dtype(torch.float16) is torch.float16
    for bad in ('int8', torch.int8):
        with pytest.raises(TypeError):
            tdtype.to_torch_dtype(bad)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tnn.Linear(4, 4)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        tdevice.resolve()
    assert tdevice.resolve('cpu') == torch.device('cpu')


# ---- _sdpa_ref recomputes its scores in the backward --------------------


def _sdpa_inputs(seed=0, b=2, n=24, h=3, d=8):
    return [torch.from_numpy(_rand(b, n, h, d, seed=seed + i))
            .requires_grad_(True) for i in range(3)]


def _saved_shapes(fn):
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, shapes


@pytest.mark.parametrize('dropout_p', [0.0, 0.2])
def test_sdpa_ref_keeps_no_scores_for_the_backward(dropout_p):
    """The JAX package wraps _sdpa_ref in jax.checkpoint; the port's keeps
    only q, k, v (and the generator state with dropout) for its backward,
    no [B, H, N, N] tensor. The plain body, for contrast, keeps several."""
    from paddle_tpu_torch.nn.functional import attention as tattn
    q, k, v = _sdpa_inputs()
    scores = {(2, 3, 24, 24), (6, 24, 24)}
    _, kept = _saved_shapes(lambda: t_sdpa_ref(
        q, k, v, None, True, 0.3, dropout_p,
        torch.Generator().manual_seed(4)))
    assert not scores & set(kept), kept
    assert sum(1 for s in kept if s == (2, 24, 3, 8)) == 3
    _, plain = _saved_shapes(lambda: tattn._sdpa_body(
        q, k, v, None, True, 0.3, dropout_p,
        torch.Generator().manual_seed(4).get_state(), []))
    assert scores & set(plain)


def test_sdpa_ref_recompute_gives_the_same_gradients():
    """Dropout on, one generator: the gradients through the recompute equal
    those of the plain body, which keeps its mask (so the recompute drew
    the same mask)."""
    from paddle_tpu_torch.nn.functional import attention as tattn
    mask = torch.from_numpy(_rand(1, 1, 24, 24, seed=9))
    grads = []
    for recompute in (True, False):
        q, k, v = _sdpa_inputs(seed=1)
        gen = torch.Generator().manual_seed(11)
        if recompute:
            out = t_sdpa_ref(q, k, v, mask, True, 0.3, 0.25, gen)
        else:
            out = tattn._sdpa_body(q, k, v, mask, True, 0.3, 0.25,
                                   gen.get_state(), [])
        out.backward(torch.from_numpy(_rand(2, 24, 3, 8, seed=7)))
        grads.append([out.detach()] + [t.grad for t in (q, k, v)])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_sdpa_ref_dropout_draws_from_the_callers_generator():
    """The mask is the one a draw from the caller's generator gives, and
    the generator advances as that one draw advances it."""
    q, k, v = (t.detach() for t in _sdpa_inputs(seed=2))
    gen = torch.Generator().manual_seed(5)
    out = t_sdpa_ref(q, k, v, None, False, 0.3, 0.5, gen)
    twin = torch.Generator().manual_seed(5)
    p = torch.softmax(torch.matmul(q.transpose(1, 2),
                                   k.transpose(1, 2).transpose(-1, -2))
                      * 0.3, dim=-1)
    want = torch.matmul(TF.dropout(p, 0.5, generator=twin),
                        v.transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(gen.get_state(), twin.get_state())


def test_sdpa_ref_without_grad_is_not_recomputed(monkeypatch):
    from paddle_tpu_torch.nn.functional import attention as tattn

    def refuse(*args, **kwargs):
        raise AssertionError('checkpoint called')

    monkeypatch.setattr(tattn, 'checkpoint', refuse)
    q, k, v = _sdpa_inputs(seed=3)
    with torch.no_grad():
        t_sdpa_ref(q, k, v, None, True, 0.3)
    t_sdpa_ref(*(t.detach() for t in (q, k, v)), None, True, 0.3)
    with pytest.raises(AssertionError, match='checkpoint called'):
        t_sdpa_ref(q, k, v, None, True, 0.3)
