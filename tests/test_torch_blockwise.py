"""The port's blockwise attention (paddle_tpu_torch/ops/blockwise_attention.py)
against the JAX package's (paddle_tpu/ops/blockwise_attention.py), forward
and gradients, and the flash entry's route for cross-length causal attention
to it. Both are plain array code (XLA on the JAX side), so they run as they
are on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import blockwise_attention as jbw
from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch.ops import blockwise_attention as tbw
from paddle_tpu_torch.ops import flash_attention as tfa

# f32 on both sides, sums over up to 1024 keys in another order
F32_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _interpret_strict(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_FLASH_INTERPRET', '1')
    monkeypatch.setenv('PADDLE_TPU_FLASH_STRICT', '1')


def _mk(n, m, d=64, b=1, h=2, seed=0, std=0.5):
    """q [b, n, h, d], k, v [b, m, h, d] and do like q, f32 numpy."""
    rng = np.random.RandomState(seed)
    return (rng.randn(b, n, h, d).astype(np.float32) * std,
            rng.randn(b, m, h, d).astype(np.float32) * std,
            rng.randn(b, m, h, d).astype(np.float32) * std,
            rng.randn(b, n, h, d).astype(np.float32))


def _both(torch_fn, jax_fn, q, k, v, do):
    """(out, grads) of torch_fn through autograd and of jax_fn through
    jax.vjp, on the same inputs."""
    targs = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = torch_fn(*targs)
    got = torch.autograd.grad(out, targs, torch.from_numpy(do))
    out_j, vjp = jax.vjp(jax_fn, *(jnp.asarray(x) for x in (q, k, v)))
    return (out.detach(), got), (out_j, vjp(jnp.asarray(do)))


def _assert_close(got, want):
    (out, grads), (out_j, grads_j) = got, want
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **F32_TOL)
    for g, w in zip(grads, grads_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)


def test_flash_routes_cross_length_causal_to_blockwise():
    # a 512-query chunk over 1024 keys: bottom-right causal, which both
    # packages send to blockwise before any kernel
    q, k, v, do = _mk(512, 1024, seed=1)
    before = dict(tfa.counts)
    got = _both(lambda a, b, c: tfa.flash_attention_bnhd(a, b, c,
                                                         causal=True),
                lambda a, b, c: jfa.flash_attention_bnhd(a, b, c,
                                                         causal=True),
                q, k, v, do)
    assert tfa.counts['blockwise'] == before['blockwise'] + 1
    for route in ('flash', 'fwd_long', 'rejected', 'bwd_fused',
                  'bwd_two_pass', 'bwd_long'):
        assert tfa.counts[route] == before[route], route
    _assert_close(*got)
    # the last query sees every key, the first the first m - n + 1
    (out, _), _ = got
    ref = jfa._ref_bhnd(*(jnp.swapaxes(jnp.asarray(x), 1, 2)
                          for x in (q, k, v)), True, 0.125)
    np.testing.assert_allclose(out.numpy(), np.swapaxes(np.asarray(ref), 1, 2),
                               **F32_TOL)


@pytest.mark.parametrize('block', [64, 128])
def test_causal_skip_matches_jax(block):
    # n == m with equal blocks, tq = 256 / block <= 64: the lower triangle
    # of blocks only
    q, k, v, do = _mk(256, 256, seed=2)
    got = _both(lambda a, b, c: tbw.blockwise_attention(
        a, b, c, causal=True, block_q=block, block_k=block),
        lambda a, b, c: jbw.blockwise_attention(
            a, b, c, causal=True, block_q=block, block_k=block),
        q, k, v, do)
    _assert_close(*got)


@pytest.mark.parametrize('n,m', [(256, 384), (384, 256)])
def test_noncausal_matches_jax(n, m):
    q, k, v, do = _mk(n, m, d=128, seed=3)
    got = _both(lambda a, b, c: tbw.blockwise_attention(
        a, b, c, block_q=128, block_k=128),
        lambda a, b, c: jbw.blockwise_attention(
            a, b, c, block_q=128, block_k=128),
        q, k, v, do)
    _assert_close(*got)


def test_masked_cross_length_causal_matches_jax():
    # causal with n < m takes the masked walk over every K/V block (no
    # causal skip); a 96-key block leaves a block whose early queries see
    # none of its keys
    q, k, v, do = _mk(64, 288, seed=4)
    got = _both(lambda a, b, c: tbw.blockwise_attention(
        a, b, c, causal=True, block_q=64, block_k=96),
        lambda a, b, c: jbw.blockwise_attention(
            a, b, c, causal=True, block_q=64, block_k=96),
        q, k, v, do)
    _assert_close(*got)


def test_bf16_close_to_jax():
    # both take native-dtype products with f32 sums and round p and o to
    # bf16: within bf16 rounding of each other
    q, k, v, _ = _mk(256, 512, seed=5)
    out = tbw.blockwise_attention(*(torch.from_numpy(x).bfloat16()
                                    for x in (q, k, v)), causal=True)
    want = jbw.blockwise_attention(*(jnp.asarray(x).astype(jnp.bfloat16)
                                     for x in (q, k, v)), causal=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), rtol=0.05,
                               atol=0.05)


def test_causal_more_queries_than_keys_raises():
    q = torch.zeros(1, 2, 512, 64)
    k = torch.zeros(1, 2, 256, 64)
    with pytest.raises(ValueError, match='more queries'):
        tbw.blockwise_attention_bnhd(q, k, k, causal=True)
    with pytest.raises(ValueError, match='more queries'):
        tfa.flash_attention_bhnd(q, k, k, causal=True)


@pytest.mark.parametrize('n,target', [(512, 512), (1024, 512), (768, 512),
                                      (300, 512), (97, 64), (1, 512)])
def test_pick_block_matches_jax(n, target):
    assert tbw._pick_block(n, target) == jbw._pick_block(n, target)
    assert tbw.BLOCK_SIZE == jbw.env_block_size() == 512


def test_backward_keeps_no_score_matrix():
    # every block step is checkpointed: what autograd saves is the inputs
    # and the O(n * d) carries, never a [n, block] or [n, m] score tile
    b, h, n, m, d = 1, 2, 512, 1024, 64
    q = torch.randn(b, h, n, d, requires_grad=True)
    k = torch.randn(b, h, m, d, requires_grad=True)
    v = torch.randn(b, h, m, d, requires_grad=True)
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = tbw.blockwise_attention_bnhd(q, k, v, causal=True,
                                           block_q=128, block_k=128)
    assert saved and max(saved) <= b * h * m * d
    out.sum().backward()
    assert q.grad.shape == q.shape and bool(torch.isfinite(k.grad).all())
