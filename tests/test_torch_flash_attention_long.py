"""The port's long-sequence flash route (paddle_tpu_torch/ops/flash_attention.py,
max(n, m) >= LONG_SEQ) against the JAX package's long kernels
(`_fwd_kernel_long`, `_bwd_dq_kernel_long`, `_bwd_dkv_kernel_long`), run
through the Pallas interpreter on the CPU under strict mode. The JAX side is
forced onto its long path (PADDLE_TPU_FLASH_FORCE_LONG=1), the port's by a
lowered LONG_SEQ; at n = m = 2048 the JAX long blocks are 512 x 1024, so its
grid walks 4 query by 2 key tiles. On the CPU the port takes the kernels'
plain versions; the CUDA kernels of csrc/flash_fwd.cu and csrc/flash_bwd.cu
are held against those on the card by chip_smoke.py, and the route counters
show which route ran."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu.ops import flash_defaults
from paddle_tpu_torch import _build
from paddle_tpu_torch.ops import flash_attention as tfa

N = 2048
DEFAULT_LONG_SEQ = tfa.LONG_SEQ

# f32 products on both sides, sums in another order (the tolerance of
# test_torch_flash_attention_bwd.py's F32_TOL); bf16 keeps 8 bits, and both
# sides round o, p, ds and the grads to it at their own points (the
# tolerance of test_torch_flash_attention.py's bf16 test)
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=0.05, atol=0.05)}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(autouse=True)
def _long_route(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_FLASH_INTERPRET', '1')
    monkeypatch.setenv('PADDLE_TPU_FLASH_STRICT', '1')
    monkeypatch.setenv('PADDLE_TPU_FLASH_FORCE_LONG', '1')
    monkeypatch.setattr(tfa, 'LONG_SEQ', 1024)


def _mk(d, seed, b=1, h=2, n=N, std=0.5):
    """q, k, v, do as [b, h, n, d] f32 numpy; the values are rounded to
    bf16 so that both dtypes see the same inputs."""
    rng = np.random.RandomState(seed)
    out = [rng.randn(b, h, n, d).astype(np.float32) * std for _ in range(4)]
    return [torch.from_numpy(x).bfloat16().float().numpy() for x in out]


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('d', [64, 128])
def test_long_route_matches_pallas_long_kernels(d, causal, dtype):
    q, k, v, do = _mk(d, seed=d + int(causal))
    scale = 1.0 / np.sqrt(d)
    jq, jk, jv, jdo = (jnp.asarray(x).astype(JAX_DTYPE[dtype])
                       for x in (q, k, v, do))
    tq, tk, tv, tdo = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))

    # forward: o and lse of _fwd_kernel_long against the split interface
    assert jfa._use_long_path(N, N) and jfa._long_blocks(N, N) == (512, 1024)
    o_j, lse_j = jfa._fwd_impl_long(jq, jk, jv, causal, scale)
    before = dict(tfa.counts)
    o_t, lse_t = tfa.forward(tq, tk, tv, causal, scale)
    assert tfa.counts['fwd_long'] == before['fwd_long'] + 1
    assert tfa.counts['flash'] == before['flash']
    assert o_t.dtype == dtype and lse_t.dtype == torch.float32
    _close(o_t, o_j, dtype)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j),
                               **TOL[torch.float32])

    # backward: _bwd_dq_kernel_long and _bwd_dkv_kernel_long through
    # jax.vjp against torch autograd, both in [B, N, H, D]
    def bnhd(x):
        return x.transpose(1, 2)

    targs = [bnhd(x).detach().requires_grad_(True) for x in (tq, tk, tv)]
    before = dict(tfa.counts)
    out = tfa.flash_attention_bnhd(*targs, causal=causal)
    got = torch.autograd.grad(out, targs, bnhd(tdo))
    assert tfa.counts['fwd_long'] == before['fwd_long'] + 1
    assert tfa.counts['bwd_long'] == before['bwd_long'] + 1
    for route in ('flash', 'bwd_fused', 'bwd_two_pass', 'rejected'):
        assert tfa.counts[route] == before[route], route
    jargs = [jnp.swapaxes(x, 1, 2) for x in (jq, jk, jv)]
    out_j, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention_bnhd(
        a, b, c, causal=causal), *jargs)
    want = vjp(jnp.swapaxes(jdo, 1, 2))
    _close(out.detach(), out_j, dtype)
    for g, w in zip(got, want):
        assert g.shape == (1, N, 2, d) and g.dtype == dtype
        _close(g, w, dtype)


def test_long_threshold_is_the_jax_packages():
    # the JAX package's default (flash_defaults.LONG_SEQ), by length alone
    assert DEFAULT_LONG_SEQ == flash_defaults.LONG_SEQ == 4096
    assert tfa.LONG_SEQ == 1024  # lowered by the fixture
    assert tfa._use_long_path(1024, 1024) and tfa._use_long_path(64, 1024)
    assert not tfa._use_long_path(1023, 1023)


@pytest.mark.parametrize('n,route', [(512, 'bwd_fused'),
                                     (1023, 'bwd_two_pass'),
                                     (1024, 'bwd_long'), (1100, 'bwd_long')])
def test_backward_route_by_length(n, route):
    # ragged lengths take the long route too: the port's kernels mask the
    # last tile, so _supported routes by length alone
    rng = np.random.RandomState(n)
    q, k, v, do = (torch.from_numpy(rng.randn(1, 1, n, 64).astype(np.float32))
                   for _ in range(4))
    before = dict(tfa.counts)
    o, lse = tfa.forward(q, k, v, True, 0.125)
    dq, dk, dv = tfa.backward(q, k, v, o, lse, do, True, 0.125)
    fwd = 'fwd_long' if route == 'bwd_long' else 'flash'
    assert tfa.counts[fwd] == before[fwd] + 1
    assert tfa.counts[route] == before[route] + 1
    assert sum(tfa.counts.values()) == sum(before.values()) + 2
    # the long route computes the same function as the plain attention
    ref = torch.softmax((q @ k.transpose(-1, -2) * 0.125).masked_fill(
        ~torch.ones(n, n, dtype=torch.bool).tril(), -1e30), -1) @ v
    np.testing.assert_allclose(o.numpy(), ref.numpy(), rtol=2e-5, atol=2e-5)
    assert dq.shape == dk.shape == dv.shape == q.shape


@pytest.mark.parametrize('wrapper', ['flash_fwd_long_cuda',
                                     'flash_bwd_dq_long_cuda',
                                     'flash_bwd_dkv_long_cuda'])
def test_long_kernel_wrappers_take_cuda_tensors_only(wrapper):
    q = torch.zeros(1, 2, 128, 64)
    row = torch.zeros(1, 2, 128, 1)
    fn = getattr(tfa, wrapper)
    before = fn.launches
    args = (q, q, q, True, 0.125) if wrapper == 'flash_fwd_long_cuda' else \
        (q, q, q, q, row, row, True, 0.125)
    with pytest.raises(ValueError, match='CUDA'):
        fn(*args)
    assert fn.launches == before


def test_long_kernel_sources_build_for_sm90a():
    src, lib = _build._target('flash_fwd')
    with open(src) as f:
        text = f.read()
    assert 'extern "C" int flash_fwd_long(' in text
    assert 'flash_attention.py:_fwd_kernel_long' in text
    src, _ = _build._target('flash_bwd')
    with open(src) as f:
        text = f.read()
    for entry in ('flash_bwd_dq_long', 'flash_bwd_dkv_long'):
        assert 'FLASH_BWD_ENTRY(%s,' % entry in text
    for kernel in ('_bwd_dq_kernel_long', '_bwd_dkv_kernel_long'):
        assert kernel in text
    assert lib.startswith(_build.BUILD_DIR) and lib.endswith('.so')
