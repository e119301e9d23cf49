"""Head dims 192 and 256: the port's flash forward and backward
(paddle_tpu_torch/ops/flash_attention.py) against the JAX package's Pallas
kernels, run through the Pallas interpreter on the CPU under strict mode.
The JAX kernels take any head_dim % 64 == 0; the port instantiates its
CUDA kernels at 64, 128, 192 and 256 (csrc/flash_fwd.cu, csrc/flash_bwd.cu;
192 and 256 on the CUDA cores, held against the plain versions on the card
by chip_smoke.py). On the CPU the port takes the plain versions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch import _build
from paddle_tpu_torch.ops import flash_attention as tfa

WIDE = (192, 256)
# f32 products on both sides, summed in another order: ~1e-6 here
F32_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _interpret_strict(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_FLASH_INTERPRET', '1')
    monkeypatch.setenv('PADDLE_TPU_FLASH_STRICT', '1')


def _mk(n, d, seed, count=3, std=0.5):
    rng = np.random.RandomState(seed)
    return [rng.randn(1, 2, n, d).astype(np.float32) * std
            for _ in range(count)]


def _torch(*arrays, dtype=torch.float32):
    return [torch.tensor(np.asarray(a, np.float32)).to(dtype)
            for a in arrays]


@pytest.mark.parametrize('n', [128, 256])
@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('d', WIDE)
def test_plain_forward_matches_pallas(d, causal, n):
    q, k, v = _mk(n, d, seed=n + d)
    scale = d ** -0.5
    o_j, lse_j = jfa._fwd_impl(*(jnp.asarray(x) for x in (q, k, v)),
                               causal, scale)
    o_t, lse_t = tfa.flash_attention_fwd_ref(*_torch(q, k, v), causal, scale)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **F32_TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **F32_TOL)


@pytest.mark.parametrize('n', [128, 256])
@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('d', WIDE)
def test_plain_backward_matches_pallas(d, causal, n):
    q, k, v, do = _mk(n, d, seed=3 * n + d, count=4)
    scale = d ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    o, lse = jfa._fwd_impl(jq, jk, jv, causal, scale)
    delta = jnp.sum(jdo * o, axis=-1, keepdims=True)
    want = jfa._bwd_impl_fused(jq, jk, jv, lse, jdo, delta, causal, scale)
    got = tfa.flash_attention_bwd_ref(
        *_torch(q, k, v, do, lse, delta), causal, scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)


@pytest.mark.parametrize('d', WIDE)
def test_plain_forward_bf16_close_to_pallas(d):
    """bf16 operands, p rounded to bf16 before p @ v on both sides. q and k
    of std 2 make the softmax peaked, so |o| is of order 1 and one bf16
    ulp (2^-7 relative) is the tolerance. Leaving p in f32 breaks it at
    ~100 elements here, letting one more key into each row at ~10^4."""
    q, k = _mk(256, d, seed=d, count=2, std=2.0)
    (v,) = _mk(256, d, seed=d + 1, count=1, std=1.0)
    scale = d ** -0.5
    o_j, _ = jfa._fwd_impl(*(jnp.asarray(x).astype(jnp.bfloat16)
                             for x in (q, k, v)), True, scale)
    o_t, _ = tfa.flash_attention_fwd_ref(
        *_torch(q, k, v, dtype=torch.bfloat16), True, scale)
    assert o_t.dtype == torch.bfloat16
    np.testing.assert_allclose(o_t.float().numpy(),
                               np.asarray(o_j, np.float32), rtol=2 ** -7,
                               atol=1e-3)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize('d', WIDE)
def test_supported_takes_wide_heads(d, dtype):
    q, k, v = (t.to(dtype) for t in _torch(*_mk(128, d, seed=1)))
    assert tfa._supported(q, k, v) is None


@pytest.mark.parametrize('d', WIDE)
def test_strict_mode_runs_wide_heads_through_flash(d):
    """Under PADDLE_TPU_FLASH_STRICT=1 a 512-token call at d = 192 / 256
    takes the flash route, as the JAX package's does, and autograd runs
    the flash backward; before slice 4 the port rejected these head dims
    and strict mode raised."""
    q, k, v, do = (np.swapaxes(x, 1, 2) for x in _mk(512, d, seed=5,
                                                      count=4))
    before = dict(tfa.counts)
    qt, kt, vt = (t.requires_grad_(True) for t in _torch(q, k, v))
    out = tfa.flash_attention_bnhd(qt, kt, vt, causal=True)
    out.backward(torch.from_numpy(do))
    assert tfa.counts['flash'] == before['flash'] + 1
    assert tfa.counts['bwd_fused'] == before['bwd_fused'] + 1
    assert tfa.counts['rejected'] == before['rejected']
    want = jfa.flash_attention_bnhd(*(jnp.asarray(x) for x in (q, k, v)),
                                    causal=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **F32_TOL)
    assert qt.grad.shape == qt.shape and bool(torch.isfinite(qt.grad).all())


def test_wrappers_still_take_cuda_tensors_only():
    q, k, v = _torch(*_mk(128, 256, seed=2))
    with pytest.raises(ValueError, match='CUDA'):
        tfa.flash_fwd_cuda(q, k, v, False, 0.0625)


@pytest.mark.parametrize('name', ['flash_fwd', 'flash_bwd'])
def test_kernel_sources_instantiate_wide_heads(name):
    src, _ = _build._target(name)
    with open(src) as f:
        text = f.read()
    for d in WIDE:
        assert 'launch_d<%d>' % d in text
    assert 'static_assert' in text and 'MAX_SMEM' in text
