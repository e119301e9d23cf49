"""The port's flash forward (paddle_tpu_torch/ops/flash_attention.py) against
the JAX package's Pallas forward, run through the Pallas interpreter on the
CPU. On the CPU the port takes the kernel's plain version; the CUDA kernel
itself is held against that plain version on the card by chip_smoke.py."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch import _build
from paddle_tpu_torch.ops import flash_attention as tfa


@pytest.fixture(autouse=True)
def _interpret_strict(monkeypatch):
    # interpreter mode => the Pallas kernel really runs on the CPU; strict
    # => any fallback on either side fails the test
    monkeypatch.setenv('PADDLE_TPU_FLASH_INTERPRET', '1')
    monkeypatch.setenv('PADDLE_TPU_FLASH_STRICT', '1')


def _mk(b=1, h=2, n=256, m=None, d=64, seed=0, std=0.5):
    m = m or n
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, n, d).astype(np.float32) * std,
            rng.randn(b, h, m, d).astype(np.float32) * std,
            rng.randn(b, h, m, d).astype(np.float32) * std)


def _torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize('n', [256, 512, 640])
@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('d', [64, 128])
def test_plain_version_matches_pallas_fwd(d, causal, n):
    q, k, v = _mk(n=n, d=d, seed=n + d)
    scale = 1.0 / np.sqrt(d)
    o_j, lse_j = jfa._fwd_impl(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal, scale)
    o_t, lse_t = tfa.flash_attention_fwd_ref(*_torch(q, k, v), causal, scale)
    assert o_t.dtype == torch.float32 and lse_t.shape == (1, 2, n, 1)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j),
                               rtol=2e-5, atol=2e-5)


def test_plain_version_bf16_close():
    # the tolerance of test_flash_attention.py::test_bf16_forward_close
    q, k, v = _mk(d=64, std=0.3)
    scale = 1.0 / np.sqrt(64)
    o_j, _ = jfa._fwd_impl(*(jnp.asarray(x).astype(jnp.bfloat16)
                             for x in (q, k, v)), True, scale)
    o_t, lse_t = tfa.flash_attention_fwd_ref(
        *_torch(q, k, v, dtype=torch.bfloat16), True, scale)
    assert o_t.dtype == torch.bfloat16 and lse_t.dtype == torch.float32
    ref = jfa._ref_bhnd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        True, scale)
    for got in (o_t.float().numpy(), np.asarray(o_j, np.float32)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0.05,
                                   atol=0.05)
    np.testing.assert_allclose(o_t.float().numpy(),
                               np.asarray(o_j, np.float32), rtol=0.05,
                               atol=0.05)


@pytest.mark.parametrize('causal', [False, True])
def test_flash_attention_bnhd_matches_jax(causal):
    q, k, v = (np.swapaxes(x, 1, 2) for x in _mk(n=512, seed=3))
    before = tfa.counts['flash']
    out_t = tfa.flash_attention_bnhd(*_torch(q, k, v), causal=causal)
    out_j = jfa.flash_attention_bnhd(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal)
    assert tfa.counts['flash'] == before + 1
    assert out_t.shape == (1, 512, 2, 64)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               rtol=2e-5, atol=2e-5)


def test_split_interface_returns_o_and_lse():
    q, k, v = _torch(*_mk(n=256))
    o, lse = tfa.forward(q, k, v, True, 0.125)
    assert o.shape == q.shape and o.dtype == q.dtype
    assert lse.shape == (1, 2, 256, 1) and lse.dtype == torch.float32
    # causal row 0 sees only key 0: lse is its scaled score
    expect = (q[..., 0, :] * k[..., 0, :]).sum(-1) * 0.125
    np.testing.assert_allclose(lse[..., 0, 0].numpy(), expect.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_strict_mode_raises_on_unsupported_head_dim():
    q, k, v = _torch(*_mk(d=80))
    before = dict(tfa.counts)
    with pytest.raises(RuntimeError, match='head_dim'):
        tfa.flash_attention_bhnd(q, k, v)
    assert tfa.counts['rejected'] == before['rejected'] + 1
    assert tfa.counts['flash'] == before['flash']


def test_strict_mode_raises_on_mixed_dtypes():
    q, k, v = _torch(*_mk())
    with pytest.raises(RuntimeError, match='mixed operand dtypes'):
        tfa.flash_attention_bhnd(q, k.to(torch.bfloat16), v)


def test_nonstrict_routes_rejected_shape_to_reference(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_FLASH_STRICT', '0')
    q, k, v = _mk(d=80)
    before = tfa.counts['rejected']
    out_t = tfa.flash_attention_bhnd(*_torch(q, k, v))
    assert tfa.counts['rejected'] == before + 1
    ref = jfa._ref_bhnd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        False, 1.0 / np.sqrt(80))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_causal_cross_length_is_not_ported():
    # the name dates from slice 1, when cross-length causal raised; slice 3
    # routes it to the bottom-right blockwise attention, as the JAX package
    # does, before any kernel
    q, k, v = _torch(*_mk(n=256, m=512))
    before = dict(tfa.counts)
    out = tfa.flash_attention_bhnd(q, k, v, causal=True)
    assert tfa.counts['blockwise'] == before['blockwise'] + 1
    assert tfa.counts['flash'] == before['flash']
    ref = jfa._ref_bhnd(*(jnp.asarray(x.numpy()) for x in (q, k, v)), True,
                        0.125)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
    # non-causal cross attention keeps to the flash forward
    out = tfa.flash_attention_bhnd(q, k, v, causal=False)
    ref = jfa._ref_bhnd(*(jnp.asarray(x.numpy()) for x in (q, k, v)), False,
                        0.125)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_kernel_wrapper_takes_cuda_tensors_only():
    q, k, v = _torch(*_mk())
    before = tfa.flash_fwd_cuda.launches
    with pytest.raises(ValueError, match='CUDA'):
        tfa.flash_fwd_cuda(q, k, v, False, 0.125)
    assert tfa.flash_fwd_cuda.launches == before


def test_kernel_operands_keep_aligned_views():
    # q/k/v sliced out of a packed [b, n, 3, h, d] projection go to the
    # kernel as they are; a view whose rows are not 16-byte aligned is copied
    qkv = torch.zeros(2, 5, 3, 4, 64, dtype=torch.bfloat16)
    q = qkv[:, :, 1].transpose(1, 2)
    assert tfa._rows_aligned(q) is q
    odd = torch.zeros(2, 3, 5, 65)[..., 1:]
    fixed = tfa._rows_aligned(odd)
    assert fixed is not odd and fixed.is_contiguous()
    assert torch.equal(fixed, odd)


def test_backward_is_not_ported():
    # the name dates from slice 1, when the backward raised; slice 2 ported
    # it, and the autograd Function now runs the plain backward on the CPU
    q, k, v = _torch(*_mk())
    q.requires_grad_(True)
    out = tfa.flash_attention_bhnd(q, k, v, causal=True)
    out.sum().backward()
    o, lse = tfa.forward(q.detach(), k, v, True, 0.125)
    do = torch.ones_like(o)
    delta = (do * o).sum(-1, keepdim=True)
    dq, _, _ = tfa.flash_attention_bwd_ref(q.detach(), k, v, do, lse, delta,
                                           True, 0.125)
    np.testing.assert_allclose(q.grad.numpy(), dq.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_kernel_source_builds_for_sm90a():
    src, lib = _build._target('flash_fwd')
    with open(src) as f:
        text = f.read()
    assert 'extern "C" int flash_fwd(' in text
    assert 'flash_attention.py:_fwd_kernel' in text
    assert 'arch=compute_90a,code=sm_90a' in _build.NVCC_FLAGS
    assert lib.startswith(_build.BUILD_DIR) and lib.endswith('.so')
