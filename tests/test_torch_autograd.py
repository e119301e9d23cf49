"""The port's autograd API (paddle_tpu_torch.autograd) against the JAX
package's: tests/test_autograd.py's cases, each run through both packages
on the same numpy inputs, the port's results held to the JAX package's.
"""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as tpt
from paddle_tpu_torch import autograd as tag


def _jt(values, grad=True):
    return paddle.to_tensor(np.asarray(values, np.float32),
                            stop_gradient=not grad)


def _tt(values, grad=True):
    return torch.tensor(np.asarray(values, np.float32), requires_grad=grad)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), j.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_backward_accumulates_like_jax():
    # simple, multi-use and across two backward calls
    jx, tx = _jt([1., 2., 3.]), _tt([1., 2., 3.])
    paddle.autograd.backward([(jx * jx).sum()])
    tag.backward([(tx * tx).sum()])
    _close(tx.grad, jx.grad)
    jy, ty = _jt([2.]), _tt([2.])
    (jy * jy + jy * 3).backward()
    (ty * ty + ty * 3).backward()
    (jy * 2).backward()
    (ty * 2).backward()
    _close(ty.grad, jy.grad)
    np.testing.assert_allclose(ty.grad.numpy(), [9.])


def test_grad_api_leaves_grad_untouched_like_jax():
    jx, tx = _jt([3.]), _tt([3.])
    (jg,) = paddle.grad(jx * jx, jx)
    (tg,) = tpt.grad(tx * tx, tx)
    _close(tg, jg)
    assert jx.grad is None and tx.grad is None
    # a stashed .grad survives the call
    (tx * 5).backward()
    tpt.grad(tx * tx, tx)
    np.testing.assert_allclose(tx.grad.numpy(), [5.])


def test_grad_unused_inputs_like_jax():
    """An input the outputs do not use: zeros by default, None with
    allow_unused=True, in both packages."""
    jx, jz = _jt([1., 2.]), _jt([4., 5.])
    tx, tz = _tt([1., 2.]), _tt([4., 5.])
    jgx, jgz = paddle.grad((jx * jx).sum(), [jx, jz])
    tgx, tgz = tpt.grad((tx * tx).sum(), [tx, tz])
    _close(tgx, jgx)
    _close(tgz, jgz)
    assert float(tgz.abs().sum()) == 0.0
    jgx, jgz = paddle.grad((jx * 3).sum(), [jx, jz], allow_unused=True)
    tgx, tgz = tpt.grad((tx * 3).sum(), [tx, tz], allow_unused=True)
    _close(tgx, jgx)
    assert jgz is None and tgz is None


def test_grad_with_grad_outputs_and_chain_like_jax():
    jx, tx = _jt([0.5, -1.5]), _tt([0.5, -1.5])
    jy = paddle.tanh(paddle.exp(jx))
    ty = torch.tanh(torch.exp(tx))
    (jg,) = paddle.grad(jy, jx, grad_outputs=_jt([1., 2.], grad=False))
    (tg,) = tpt.grad(ty, tx, grad_outputs=_tt([1., 2.], grad=False))
    np.testing.assert_allclose(tg.numpy(), jg.numpy(), rtol=1e-6)


def test_create_graph_raises_like_jax():
    jx, tx = _jt([1.]), _tt([1.])
    with pytest.raises(NotImplementedError):
        paddle.grad(jx * jx, jx, create_graph=True)
    with pytest.raises(NotImplementedError):
        tpt.grad(tx * tx, tx, create_graph=True)


def test_non_scalar_backward_needs_grad_tensor_like_jax():
    jx, tx = _jt([1., 2.]), _tt([1., 2.])
    with pytest.raises(RuntimeError):
        (jx * 2).backward()
    with pytest.raises(RuntimeError):
        (tx * 2).backward()
    tag.backward_mode.backward([tx * 2], [torch.ones(2)])
    paddle.autograd.backward_mode.backward([jx * 2], [_jt([1., 1.], False)])
    _close(tx.grad, jx.grad)


def test_diamond_graph_like_jax():
    def f(pkg_x):
        a = pkg_x * 2
        return ((a + 1) * (a * 3)).sum()
    jx, tx = _jt([1.]), _tt([1.])
    f(jx).backward()
    f(tx).backward()
    _close(tx.grad, jx.grad)
    np.testing.assert_allclose(tx.grad.numpy(), [30.])


def _pylayers(pkg_autograd):
    class Cube(pkg_autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, scale=1.0):
            ctx.save_for_backward(x)
            ctx.container = scale
            return x * x * x * scale

        @staticmethod
        def backward(ctx, grad):
            x, = ctx.saved_tensor()
            return grad * 3 * x * x * ctx.container

    class Legacy(pkg_autograd.LegacyPyLayer):
        @staticmethod
        def forward(ctx, x, y):
            return x * 2, y + 1

        @staticmethod
        def backward(ctx, gx, gy):
            return gx * 2, gy

    return Cube, Legacy


def test_pylayer_like_jax():
    jcube, jlegacy = _pylayers(paddle.autograd)
    tcube, tlegacy = _pylayers(tag)
    jx, tx = _jt([1.5, -2.]), _tt([1.5, -2.])
    jy, ty = jcube.apply(jx, scale=2.0), tcube.apply(tx, scale=2.0)
    _close(ty, jy)
    jy.sum().backward()
    ty.sum().backward()
    _close(tx.grad, jx.grad)
    ja, jb = _jt([1., 2.]), _jt([3., 4.])
    ta, tb = _tt([1., 2.]), _tt([3., 4.])
    jo = jlegacy.apply(ja, jb)
    to = tlegacy.apply(ta, tb)
    (jo[0] * jo[1]).sum().backward()
    (to[0] * to[1]).sum().backward()
    _close(ta.grad, ja.grad)
    _close(tb.grad, jb.grad)
    # without an input that needs a gradient nothing is recorded
    assert not tcube.apply(_tt([1.], grad=False)).requires_grad


def test_grad_mode_switches_like_jax():
    jx, tx = _jt([1.]), _tt([1.])
    with paddle.no_grad():
        jy = jx * 2
    with tpt.no_grad():
        ty = tx * 2
    assert jy.stop_gradient and not ty.requires_grad
    assert tpt.is_grad_enabled() and paddle.is_grad_enabled()
    with tpt.no_grad():
        with tpt.enable_grad():
            assert (tx * 2).requires_grad
    with tpt.set_grad_enabled(False):
        assert not tpt.is_grad_enabled()
    assert tpt.is_grad_enabled()


def test_no_grad_is_thread_local():
    """Interleaved no_grad enter / exit in other threads never turns the
    main thread's grad mode off (tests/test_autograd.py's contract)."""
    stop = threading.Event()

    def churn():
        while not stop.is_set():
            with tpt.no_grad():
                pass

    threads = [threading.Thread(target=churn) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        seen_disabled = [not tpt.is_grad_enabled() for _ in range(200)]
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert not any(seen_disabled)
    x = _tt([2.])
    (x * x).backward()
    np.testing.assert_allclose(x.grad.numpy(), [4.])
