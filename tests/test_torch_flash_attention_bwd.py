"""The port's flash attention backward (paddle_tpu_torch/ops/flash_attention.py)
against the JAX package's Pallas backward kernels, run through the Pallas
interpreter on the CPU under strict mode. On the CPU the port takes the
kernels' plain version `flash_attention_bwd_ref`; the CUDA kernels of
csrc/flash_bwd.cu are held against that plain version on the card by
chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch import _build
from paddle_tpu_torch.ops import flash_attention as tfa


@pytest.fixture(autouse=True)
def _interpret_strict(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_FLASH_INTERPRET', '1')
    monkeypatch.setenv('PADDLE_TPU_FLASH_STRICT', '1')


def _mk(b=1, h=2, n=512, d=64, seed=0, std=0.5):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, n, d).astype(np.float32) * std for _ in range(4)]


def _torch(*arrays, dtype=torch.float32):
    return [torch.tensor(np.asarray(a, np.float32)).to(dtype)
            for a in arrays]


# f32 products on both sides; sums over up to 1024 keys in another order
# leave ~1e-6 on gradients of magnitude ~1
F32_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize('causal', [False, True])
def test_plain_version_matches_pallas_fused_bwd(causal):
    q, k, v, do = _mk(seed=1)
    scale = 0.125
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    o, lse = jfa._fwd_impl(jq, jk, jv, causal, scale)
    delta = jnp.sum(jdo * o, axis=-1, keepdims=True)
    want = jfa._bwd_impl_fused(jq, jk, jv, lse, jdo, delta, causal, scale)
    got = tfa.flash_attention_bwd_ref(
        *_torch(q, k, v, do, lse, delta), causal, scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)


@pytest.mark.parametrize('causal', [False, True])
def test_plain_version_matches_pallas_two_pass_bwd(causal):
    # n = 1024 exceeds one 512 block: the JAX package runs _bwd_dq_kernel
    # and _bwd_dkv_kernel
    q, k, v, do = _mk(n=1024, seed=2)
    scale = 0.125
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    o, lse = jfa._fwd_impl(jq, jk, jv, causal, scale)
    want = jfa._bwd_impl(jq, jk, jv, o, lse, jdo, causal, scale)
    delta = (torch.from_numpy(do) * torch.tensor(np.asarray(o))).sum(
        -1, keepdim=True)
    got = tfa.flash_attention_bwd_ref(
        *_torch(q, k, v, do, lse), delta, causal, scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)


@pytest.mark.parametrize('n,m,d', [(512, 1024, 64), (1024, 512, 128),
                                   (640, 1152, 64)])
def test_plain_version_matches_pallas_two_pass_bwd_cross_length(n, m, d):
    # non-causal n != m, as ring attention calls the dq and dk/dv pair:
    # the JAX package runs _bwd_dq_kernel and _bwd_dkv_kernel
    rng = np.random.RandomState(n + m + d)
    q, do = (rng.randn(1, 2, n, d).astype(np.float32) * 0.5 for _ in range(2))
    k, v = (rng.randn(1, 2, m, d).astype(np.float32) * 0.5 for _ in range(2))
    scale = 1.0 / np.sqrt(d)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    o, lse = jfa._fwd_impl(jq, jk, jv, False, scale)
    want = jfa._bwd_impl(jq, jk, jv, o, lse, jdo, False, scale)
    delta = (torch.from_numpy(do) * torch.tensor(np.asarray(o))).sum(
        -1, keepdim=True)
    got = tfa.flash_attention_bwd_ref(
        *_torch(q, k, v, do, lse), delta, False, scale)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)


def test_plain_version_bf16_close_to_pallas():
    # both round p and ds to bf16 before the products they feed; they may
    # round a value near a boundary differently, and the grads are bf16
    # (8 bits): 2 % of the largest gradient
    q, k, v, do = _mk(seed=3)
    scale = 0.125
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jnp.bfloat16)
                       for x in (q, k, v, do))
    o, lse = jfa._fwd_impl(jq, jk, jv, True, scale)
    delta = jnp.sum(jdo.astype(jnp.float32) * o.astype(jnp.float32),
                    axis=-1, keepdims=True)
    want = jfa._bwd_impl_fused(jq, jk, jv, lse, jdo, delta, True, scale)
    tq, tk, tv, tdo = _torch(*(np.asarray(x, np.float32)
                               for x in (jq, jk, jv, jdo)),
                             dtype=torch.bfloat16)
    got = tfa.flash_attention_bwd_ref(
        tq, tk, tv, tdo, *_torch(lse, delta), True, scale)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w, np.float32)
        err = np.abs(g.float().numpy() - w).max()
        assert err <= 0.02 * np.abs(w).max(), err


@pytest.mark.parametrize('n,route', [(512, 'bwd_fused'),
                                     (1024, 'bwd_two_pass')])
@pytest.mark.parametrize('causal', [False, True])
def test_autograd_matches_jax_vjp(causal, n, route):
    q, k, v, do = (np.swapaxes(x, 1, 2) for x in _mk(n=n, seed=n))
    tq, tk, tv = (t.requires_grad_(True) for t in _torch(q, k, v))
    before = dict(tfa.counts)
    out = tfa.flash_attention_bnhd(tq, tk, tv, causal=causal)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    assert tfa.counts[route] == before[route] + 1
    other = ({'bwd_fused', 'bwd_two_pass'} - {route}).pop()
    assert tfa.counts[other] == before[other]
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention_bnhd(
        a, b, c, causal=causal), *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    for g, w in zip(got, want):
        assert g.shape == (1, n, 2, 64)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)


@pytest.mark.parametrize('n,route', [(300, 'bwd_fused'), (512, 'bwd_fused'),
                                     (513, 'bwd_two_pass'),
                                     (700, 'bwd_two_pass')])
def test_backward_route_follows_the_512_block(n, route):
    q, k, v, do = _torch(*_mk(h=1, n=n, seed=4))
    o, lse = tfa.forward(q, k, v, True, 0.125)
    before = tfa.counts[route]
    dq, dk, dv = tfa.backward(q, k, v, o, lse, do, True, 0.125)
    assert tfa.counts[route] == before + 1
    assert dq.shape == dk.shape == dv.shape == q.shape


def test_backward_causal_cross_length_is_not_ported():
    # the name dates from slice 2, when this raised NotImplementedError;
    # slice 3 sends cross-length causal to the blockwise attention before
    # any kernel, so the split backward (top-left causal, the kernels'
    # contract) refuses it
    q = torch.zeros(1, 2, 256, 64)
    k = torch.zeros(1, 2, 512, 64)
    with pytest.raises(ValueError, match='top-left causal'):
        tfa.backward(q, k, k, q, torch.zeros(1, 2, 256, 1), q, True, 0.125)
    with pytest.raises(ValueError, match='top-left causal'):
        tfa.forward(q, k, k, True, 0.125)


@pytest.mark.parametrize('wrapper', ['flash_bwd_fused_cuda',
                                     'flash_bwd_dq_cuda',
                                     'flash_bwd_dkv_cuda'])
def test_backward_kernel_wrappers_take_cuda_tensors_only(wrapper):
    q, k, v, do = _torch(*_mk(n=128))
    row = torch.zeros(1, 2, 128, 1)
    fn = getattr(tfa, wrapper)
    before = fn.launches
    with pytest.raises(ValueError, match='CUDA'):
        fn(q, k, v, do, row, row, True, 0.125)
    assert fn.launches == before


def test_backward_kernel_source_builds_for_sm90a():
    src, lib = _build._target('flash_bwd')
    with open(src) as f:
        text = f.read()
    for entry in ('flash_bwd_fused', 'flash_bwd_dq', 'flash_bwd_dkv'):
        assert 'FLASH_BWD_ENTRY(%s,' % entry in text
    for kernel in ('_bwd_fused_kernel', '_bwd_dq_kernel', '_bwd_dkv_kernel'):
        assert kernel in text
    assert '#include "mma_sm90.cuh"' in text
    assert lib.startswith(_build.BUILD_DIR) and lib.endswith('.so')
