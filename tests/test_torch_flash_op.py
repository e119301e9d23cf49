"""The flash kernels as torch.library custom ops
(paddle_tpu_torch::flash_fwd / flash_bwd in
paddle_tpu_torch/ops/flash_attention.py): their schemas, fake and autograd
registrations under torch.library.opcheck, fake strides equal to the real
outputs' (o, dq, dk and dv laid out [b, rows, h, d]), counters that count
when the ops run and not when they are traced, and the gradients through
the forward op's autograd against the JAX package's Pallas kernels run
through the interpreter under strict mode. On the CPU the op bodies run
the kernels' plain versions; chip_smoke.py runs opcheck on the card, where
they launch the CUDA kernels."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch.ops import flash_attention as tfa


@pytest.fixture(autouse=True)
def _interpret_strict(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_FLASH_INTERPRET', '1')
    monkeypatch.setenv('PADDLE_TPU_FLASH_STRICT', '1')


def _qkv(b=1, h=2, n=64, d=64, seed=0, grad=False):
    """q, k, v [b, h, n, d] as views of one packed [b, n, 3, h, d]
    projection, as the GPT's attention hands them over."""
    rng = np.random.RandomState(seed)
    qkv = torch.from_numpy(
        (rng.randn(b, n, 3, h, d) * 0.5).astype(np.float32))
    if grad:
        qkv.requires_grad_(True)
    return [qkv[:, :, i].transpose(1, 2) for i in range(3)]


@pytest.mark.parametrize('causal', [False, True])
def test_opcheck_forward(causal):
    q, k, v = (t.detach().clone().requires_grad_(True) for t in _qkv())
    torch.library.opcheck(tfa.flash_fwd_op, (q, k, v, causal, 0.125))


@pytest.mark.parametrize('causal,n', [(False, 64), (True, 64), (True, 1024)])
def test_opcheck_backward(causal, n):
    # n = 1024 takes the two-pass route
    q, k, v = _qkv(n=n, h=1, seed=n)
    o, lse = tfa.flash_fwd_op(q, k, v, causal, 0.125)
    do = torch.randn_like(o)
    torch.library.opcheck(tfa.flash_bwd_op,
                          (q, k, v, o, lse, do, causal, 0.125))


@pytest.mark.parametrize('n', [64, 4096])
def test_fake_outputs_have_the_real_strides(n):
    """The fake implementations promise the kernels' layout, on both
    routes (n = 4096 is the long route), and tracing counts nothing."""
    q, k, v = _qkv(n=n, h=1, seed=1)
    o, lse = tfa.flash_fwd_op(q, k, v, True, 0.125)
    grads = tfa.flash_bwd_op(q, k, v, o, lse, torch.ones_like(o), True,
                             0.125)
    do = torch.ones_like(o)
    before = dict(tfa.counts)
    with FakeTensorMode() as mode:
        fq, fk, fv, fdo = (mode.from_tensor(t) for t in (q, k, v, do))
        fo, flse = tfa.flash_fwd_op(fq, fk, fv, True, 0.125)
        fgrads = tfa.flash_bwd_op(fq, fk, fv, fo, flse, fdo, True, 0.125)
    assert tfa.counts == before
    for real, fake in zip((o, lse) + grads, (fo, flse) + fgrads):
        assert fake.shape == real.shape and fake.dtype == real.dtype
        assert fake.stride() == real.stride()
    b, h, _, d = q.shape
    assert o.stride() == (n * h * d, d, h * d, 1)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, n, 1)
    for g in grads:
        assert g.stride() == o.stride()


def test_counters_count_each_call_in_the_op_bodies():
    q, k, v = _qkv(grad=True)
    before = dict(tfa.counts)
    for _ in range(3):
        out = tfa.flash_attention_bhnd(q, k, v, causal=True)
        out.sum().backward()
    assert tfa.counts['flash'] == before['flash'] + 3
    assert tfa.counts['bwd_fused'] == before['bwd_fused'] + 3
    assert not hasattr(tfa, '_FlashForward')


@pytest.mark.parametrize('causal', [False, True])
def test_op_gradients_match_pallas(causal):
    """Gradients through the forward op's autograd (the backward op) of
    packed strided views, at n = 512 (the fused route), against
    jax.grad of the JAX package's flash attention."""
    q, k, v = _qkv(n=512, seed=7, grad=True)
    qkv = q._base
    rng = np.random.RandomState(8)
    w = rng.randn(1, 2, 512, 64).astype(np.float32)
    out = tfa.flash_attention_bhnd(q, k, v, causal=causal)
    (out * torch.from_numpy(w)).sum().backward()
    o, lse = tfa.flash_fwd_op(q, k, v, causal, 0.125)
    assert o.requires_grad and not lse.requires_grad

    arrs = [jnp.asarray(t.detach().numpy()) for t in (q, k, v)]

    def loss(q_, k_, v_):
        return jnp.sum(jfa.flash_attention_bhnd(q_, k_, v_, causal=causal) *
                       jnp.asarray(w))

    want = jax.grad(loss, argnums=(0, 1, 2))(*arrs)
    got = qkv.grad.numpy()
    for i, wg in enumerate(want):
        np.testing.assert_allclose(got[:, :, i].transpose(0, 2, 1, 3),
                                   np.asarray(wg), rtol=2e-5, atol=2e-5)
