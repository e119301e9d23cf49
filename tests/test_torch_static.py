"""The port's static graph (paddle_tpu_torch/static/, framework/recorder.py)
against the JAX package's paddle_tpu.static.

The seven cases of tests/test_static_executor.py run through both packages
on the same feeds and weights; a float-fed attention Program at n = 512
replays in both; a 1-layer GPT Program (vocab 128, hidden 64, seq 512)
replays fresh ids and equals the JAX package's eager forward (the JAX
package's own replay keeps the ids of the build: its F.embedding closes
over them, paddle_tpu/nn/functional/common.py:120-132); the flash op is
counted once per layer per run; append_backward's pairs equal the JAX
package's; the control-flow ops replay inside a compiled Program; the
conv / norm builders raise naming their queue item. The JAX side runs its
Pallas kernels through the interpreter under strict mode.

Replays compile with Inductor on the CPU (one compile thread).
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import numpy as np
import pytest
import torch
import torch._inductor.config as inductor_config

import paddle_tpu as paddle
import paddle_tpu_torch as tpt
from paddle_tpu import static as jstatic
from paddle_tpu.text.models.gpt import GPTConfig as JConfig
from paddle_tpu.text.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch import static
from paddle_tpu_torch.framework import device as device_mod
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.text.models import gpt as tgpt

TOL = dict(rtol=1e-5, atol=1e-5)
GPT_TOL = dict(rtol=1e-4, atol=1e-4)
GPT_CFG = dict(vocab_size=128, hidden_size=64, num_layers=1, num_heads=1,
               max_position_embeddings=512, dropout=0.0)


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_FLASH_INTERPRET', '1')
    monkeypatch.setenv('PADDLE_TPU_FLASH_STRICT', '1')
    monkeypatch.setattr(inductor_config, 'compile_threads', 1)
    saved = device_mod._STATE['device']
    tpt.set_device('cpu')
    yield
    device_mod._STATE['device'] = saved


def _linear_pair(seed, n_in, n_out):
    """A JAX Linear and a port Linear with the same weights."""
    paddle.seed(seed)
    jlin = paddle.nn.Linear(n_in, n_out)
    tlin = tpt.nn.Linear(n_in, n_out)
    tlin.load_state_dict({k: torch.from_numpy(np.array(v.numpy()))
                          for k, v in jlin.state_dict().items()})
    return jlin, tlin


def _build_pair(seed=11):
    """tests/test_static_executor.py's program in both packages."""
    jlin, tlin = _linear_pair(seed, 8, 3)
    jprog = jstatic.Program()
    with jstatic.program_guard(jprog):
        jx = jstatic.data('x', [4, 8], 'float32')
        jout = paddle.nn.functional.relu(jlin(jx))
    prog = static.Program()
    with static.program_guard(prog):
        x = static.data('x', [4, 8], 'float32')
        out = torch.relu(tlin(x))
    return (jprog, jx, jout), (prog, x, out), tlin


# -- the seven cases of tests/test_static_executor.py -------------------------

def test_executor_replays_fresh_feeds_as_jax():
    (jprog, _, jout), (prog, _, out), lin = _build_pair()
    jexe, exe = jstatic.Executor(), static.Executor()
    rng = np.random.RandomState(0)
    feeds = [rng.randn(4, 8).astype(np.float32) for _ in range(2)]
    got = []
    for f in feeds:
        want = jexe.run(jprog, feed={'x': f}, fetch_list=[jout])[0]
        r = exe.run(prog, feed={'x': f}, fetch_list=[out])[0]
        np.testing.assert_allclose(r, want, **TOL)
        w, b = lin.weight.detach().numpy(), lin.bias.detach().numpy()
        np.testing.assert_allclose(r, np.maximum(f @ w + b, 0), **TOL)
        got.append(r)
    assert not np.allclose(got[0], got[1])
    assert prog.program_count() == 1 and prog.compile_count() == 1
    # the device form: tensors, and no new compile for the signature
    t, = exe.run(prog, feed={'x': feeds[0]}, fetch_list=[out],
                 return_numpy=False)
    assert isinstance(t, torch.Tensor) and t.device.type == 'cpu'
    np.testing.assert_array_equal(t.numpy(), got[0])
    assert prog.compile_count() == 1


def test_executor_raises_on_unrecorded_program_as_jax():
    for pkg, lin in ((jstatic, paddle.nn.Linear(2, 2)),
                     (static, tpt.nn.Linear(2, 2))):
        prog = pkg.Program()
        x = pkg.data('x', [2, 2], 'float32')
        prog._feed_vars['x'] = x
        y = lin(x)
        with pytest.raises(RuntimeError, match='program_guard'):
            pkg.Executor().run(prog, feed={'x': np.ones((2, 2), np.float32)},
                               fetch_list=[y])
        with pytest.raises(KeyError, match='not a declared feed'):
            pkg.Executor().run(prog, feed={'nope': np.ones(2, np.float32)})


def test_save_load_inference_model_roundtrip_as_jax(tmp_path):
    (jprog, jx, jout), (prog, x, out), _ = _build_pair(5)
    feed = np.random.RandomState(1).randn(4, 8).astype(np.float32)
    jexe, exe = jstatic.Executor(), static.Executor()
    jx.name = 'x'
    jstatic.save_inference_model(str(tmp_path / 'j'), [jx], [jout], jexe,
                                 program=jprog)
    static.save_inference_model(str(tmp_path / 't'), [x], [out], exe,
                                program=prog)
    jprog2, jnames, jfetch = jstatic.load_inference_model(
        str(tmp_path / 'j'), jexe)
    prog2, names, fetch = static.load_inference_model(str(tmp_path / 't'),
                                                      exe)
    assert names == jnames == ['x'] and fetch == jfetch
    want = jexe.run(jprog2, feed={'x': feed}, fetch_list=jfetch)[0]
    got = exe.run(prog2, feed={'x': feed}, fetch_list=fetch)[0]
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        got, exe.run(prog, feed={'x': feed}, fetch_list=[out])[0], **TOL)
    assert prog2.compile_count() == 1


def test_fluid_era_static_surface_as_jax(tmp_path):
    import paddle_tpu.nn.functional as JF

    # append_backward returns (param, grad) pairs off the autograd graph
    jlin, tlin = _linear_pair(0, 3, 2)
    ones, zeros = np.ones((4, 3), np.float32), np.zeros((4, 2), np.float32)
    jloss = JF.mse_loss(jlin(paddle.to_tensor(ones)), paddle.to_tensor(zeros))
    jpairs = jstatic.append_backward(jloss)
    tloss = torch.nn.functional.mse_loss(tlin(torch.from_numpy(ones)),
                                         torch.from_numpy(zeros))
    pairs = static.append_backward(tloss)
    assert {id(p) for p, _ in pairs} == {id(tlin.weight), id(tlin.bias)}
    jgrad = {id(p): g for p, g in jpairs}
    for (name, p), (_, jp) in zip(tlin.named_parameters(),
                                  jlin.named_parameters()):
        g = dict((id(q), h) for q, h in pairs)[id(p)]
        np.testing.assert_allclose(g.numpy(), jgrad[id(jp)].numpy(),
                                   err_msg=name, **TOL)

    # gradients() goes through autograd.grad
    a = torch.tensor([2.0], requires_grad=True)
    (ga,) = static.gradients([a * a], [a])
    ja = paddle.to_tensor(np.asarray([2.0], np.float32), stop_gradient=False)
    (jga,) = jstatic.gradients([ja * ja], [ja])
    np.testing.assert_allclose(ga.numpy(), jga.numpy())

    # scope machinery
    for pkg in (jstatic, static):
        sc = pkg.Scope()
        with pkg.scope_guard(sc):
            v = pkg.create_global_var([2], 1.5, 'float32', name='gv')
            assert pkg.global_scope().find_var('gv') is v
        assert pkg.global_scope().find_var('gv') is None

    # py_func wraps a host callable as an op
    res = static.py_func(lambda arr: arr * 3.0, torch.tensor([1.0, 2.0]),
                         torch.zeros(2))
    jres = jstatic.py_func(lambda arr: arr * 3.0,
                           paddle.to_tensor(np.asarray([1., 2.], np.float32)),
                           paddle.to_tensor(np.zeros(2, np.float32)))
    np.testing.assert_allclose(res.numpy(), np.asarray(jres.numpy()))

    # serialize / deserialize and normalize a recorded program
    jlin2, tlin2 = _linear_pair(3, 3, 2)
    jprog, prog = jstatic.Program(), static.Program()
    with jstatic.program_guard(jprog):
        jinp = jstatic.data('x', [2, 3], 'float32')
        jout = jlin2(jinp)
    with static.program_guard(prog):
        inp = static.data('x', [2, 3], 'float32')
        out = tlin2(inp)
    feed = np.random.RandomState(0).randn(2, 3).astype(np.float32)
    jexe, exe = jstatic.Executor(), static.Executor()
    want = jexe.run(jstatic.deserialize_program(
        jstatic.serialize_program([jinp], [jout], program=jprog)),
        feed={'x': feed}, fetch_list=[0])[0]
    blob = static.serialize_program([inp], [out], program=prog)
    got = exe.run(static.deserialize_program(blob), feed={'x': feed},
                  fetch_list=[0])[0]
    np.testing.assert_allclose(got, want, **TOL)
    got2 = exe.run(static.normalize_program(prog, [inp], [out]),
                   feed={'x': feed}, fetch_list=[0])[0]
    np.testing.assert_allclose(got2, got, rtol=1e-6)


def _both(fn):
    """fn(pkg, tensor, value) run through both packages, results as numpy."""
    def jt(a, grad=False):
        return paddle.to_tensor(np.asarray(a), stop_gradient=not grad)

    def tt(a, grad=False):
        return torch.tensor(np.asarray(a), requires_grad=grad)
    return fn(jstatic, jt), fn(static, tt)


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x.numpy())


def test_static_nn_control_flow_as_jax():
    def run(pkg, t):
        out = {}
        x = t(np.asarray([2.0], np.float32), grad=True)
        for flag in (True, False):
            o = pkg.nn.cond(t(flag), lambda: x * 3, lambda: x * 5)
            (g,) = pkg.gradients([o], [x])
            out['cond', flag] = (_np(o), _np(g))
        out['switch'] = _np(pkg.nn.switch_case(
            t(1), {0: lambda: t(np.float32(10.)),
                   1: lambda: t(np.float32(20.))}))
        iv, sv = pkg.nn.while_loop(
            lambda i, s: i < 5, lambda i, s: [i + 1, s + 2.0],
            [t(np.asarray(0, np.int32)), t(np.asarray(0.0, np.float32))])
        out['while'] = (_np(iv), _np(sv))
        out['case'] = _np(pkg.nn.case(
            [(t(False), lambda: t(np.float32(1.))),
             (t(True), lambda: t(np.float32(2.)))],
            default=lambda: t(np.float32(3.))))
        with pytest.raises(NotImplementedError, match='sequence'):
            pkg.nn.sequence_pool(None, 'sum')
        return out
    want, got = _both(run)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   err_msg=str(k))
    assert got['cond', True][1] == [3.0] and got['cond', False][1] == [5.0]
    assert got['while'] == (5, 10.0)
    # while_loop's outputs stop the gradient, as in the JAX package
    x = torch.tensor(1.0, requires_grad=True)
    (xv,) = static.nn.while_loop(lambda v: v < 3, lambda v: [v * 2], [x])
    assert not xv.requires_grad and xv.item() == 4.0


def test_static_nn_cond_list_outputs_and_switch_grads_as_jax():
    def run(pkg, t):
        x = t(np.asarray([2.0], np.float32), grad=True)
        a, b = pkg.nn.cond(t(True), lambda: [x * 3, x * 7],
                           lambda: [x * 5, x * 9])
        (ga,) = pkg.gradients([a + b], [x])
        r = pkg.nn.switch_case(t(1), {0: lambda: x * 10, 1: lambda: x * 20})
        (gr,) = pkg.gradients([r], [x])
        r3 = pkg.nn.switch_case(t(7), [lambda: x * 1, lambda: x * 2],
                                default=lambda: x * 4)
        with pytest.raises(ValueError, match='at least one'):
            pkg.nn.switch_case(t(0), [])
        return [_np(a), _np(b), _np(ga), _np(r), _np(gr), _np(r3)]
    want, got = _both(run)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w)
    assert [float(v[0]) for v in got] == [6.0, 14.0, 10.0, 40.0, 20.0, 8.0]


def test_static_nn_cond_structure_checks_as_jax():
    for pkg, t in ((jstatic, paddle.to_tensor), (static, torch.tensor)):
        x = t(np.asarray([2.0], np.float32))
        with pytest.raises(TypeError, match='same structure'):
            pkg.nn.cond(t(True), lambda: [x * 3, x * 7],
                        lambda: [x * 5, [x * 9]])
        with pytest.raises(ValueError, match='non-negative'):
            pkg.nn.switch_case(t(0), {-1: lambda: x, 0: lambda: x * 2})
        assert pkg.nn.cond(t(True), lambda: None, lambda: None) is None


# -- the slice's own cases ----------------------------------------------------

def test_float_fed_attention_program_replays_as_jax():
    """q, k, v fed as floats at n = 512 (one head of 64): the attention
    takes the flash route in both packages, and each replay of two fresh
    feeds agrees; the port's flash op runs once a replay."""
    jlin, tlin = _linear_pair(7, 64, 64)
    shape = [1, 512, 1, 64]
    jprog, prog = jstatic.Program(), static.Program()
    with jstatic.program_guard(jprog):
        jq, jk, jv = (jstatic.data(n, shape, 'float32') for n in 'qkv')
        jo = paddle.nn.functional.scaled_dot_product_attention(
            jq, jk, jv, is_causal=True)
        jout = jlin(paddle.reshape(jo, [1, 512, 64]))
    with static.program_guard(prog):
        q, k, v = (static.data(n, shape, 'float32') for n in 'qkv')
        o = tpt.nn.functional.scaled_dot_product_attention(q, k, v,
                                                           is_causal=True)
        out = tlin(o.reshape(1, 512, 64))
    rng = np.random.RandomState(9)
    jexe, exe = jstatic.Executor(), static.Executor()
    got = []
    for _ in range(2):
        feed = {n: rng.randn(*shape).astype(np.float32) for n in 'qkv'}
        want = jexe.run(jprog, feed=feed, fetch_list=[jout])[0]
        before = tfa.counts['flash']
        r = exe.run(prog, feed=feed, fetch_list=[out])[0]
        assert tfa.counts['flash'] == before + 1
        np.testing.assert_allclose(r, want, **TOL)
        got.append(r)
    assert not np.allclose(got[0], got[1])
    assert prog.compile_count() == 1


@pytest.fixture(scope='module')
def gpt_pair():
    paddle.seed(3)
    jm = JGPT(JConfig(**GPT_CFG))
    jm.eval()
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**GPT_CFG), device='cpu').eval()
    tgpt.load_paddle_tpu_state(tm, {k: np.asarray(v.numpy())
                                    for k, v in jm.state_dict().items()})
    return jm, tm


def test_gpt_program_replays_fresh_ids_as_jax_eager(gpt_pair):
    jm, tm = gpt_pair
    prog = static.Program()
    with static.program_guard(prog):
        ids = static.data('ids', [1, 512], 'int64')
        logits = tm(ids)
    exe = static.Executor('cpu')
    rng = np.random.RandomState(0)
    got = []
    for _ in range(2):
        feed = rng.randint(0, GPT_CFG['vocab_size'], (1, 512))
        before = tfa.counts['flash']
        r = exe.run(prog, feed={'ids': feed}, fetch_list=[logits])[0]
        assert tfa.counts['flash'] == before + GPT_CFG['num_layers']
        want = np.asarray(jm(paddle.to_tensor(feed.astype(np.int32))).numpy())
        np.testing.assert_allclose(r, want, **GPT_TOL)
        got.append(r)
    assert not np.allclose(got[0], got[1])
    assert prog.program_count() == 1 and prog.compile_count() == 1


def test_append_backward_pairs_as_jax(gpt_pair):
    """The fused-loss GPT's (parameter, grad) pairs from append_backward
    inside a program_guard, against the JAX package's; the fused backward
    runs once per layer."""
    jm0, tm0 = gpt_pair
    cfg = dict(GPT_CFG, fused_loss=True)
    jm = JGPT(JConfig(**cfg))
    jm.set_state_dict(jm0.state_dict())
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**cfg), device='cpu')
    tm.load_state_dict(tm0.state_dict())
    rng = np.random.RandomState(4)
    ids, labels = (rng.randint(0, GPT_CFG['vocab_size'], (1, 512))
                   for _ in range(2))
    jprog, prog = jstatic.Program(), static.Program()
    with jstatic.program_guard(jprog):
        jloss = jm.loss(jm(paddle.to_tensor(ids.astype(np.int32))),
                        paddle.to_tensor(labels.astype(np.int32)))
        jpairs = jstatic.append_backward(jloss)
    before = tfa.counts['bwd_fused']
    with static.program_guard(prog):
        loss = tm.loss(tm(torch.from_numpy(ids)), torch.from_numpy(labels))
        pairs = static.append_backward(loss)
    assert tfa.counts['bwd_fused'] == before + GPT_CFG['num_layers']
    np.testing.assert_allclose(loss.item(), float(jloss.numpy()), **GPT_TOL)
    jnames = {id(p): n for n, p in jm.named_parameters()}
    tnames = {id(p): n for n, p in tm.named_parameters()}
    want = {jnames[id(p)]: np.asarray(g.numpy()) for p, g in jpairs}
    got = {tnames[id(p)]: g.numpy() for p, g in pairs}
    assert set(got) == set(want) == set(tnames.values())
    for name, g in got.items():
        np.testing.assert_allclose(g, want[name], err_msg=name, **GPT_TOL)
    # the backward was not recorded into the program
    assert not any('backward' in str(c.func) for c in prog._ops)
    only = static.append_backward(
        tm.loss(tm(torch.from_numpy(ids)), torch.from_numpy(labels)),
        parameter_list=[tm.gpt.ln_f.weight])
    assert [p for p, _ in only] == [tm.gpt.ln_f.weight]


def test_control_flow_replays_in_a_program_as_jax():
    """cond and switch_case recorded in a Program replay from fresh feeds
    inside one compiled graph, as the JAX package replays them; the
    port's while_loop replays too (the JAX package's runs at build), and
    so does a predicate computed in the Program (the JAX package keeps its
    build-time value: its comparison is not a recorded op)."""
    def build(pkg, data):
        c = data('c', [1], 'bool')
        v = data('v', [3], 'float32')
        k = data('k', [1], 'int64')
        o = pkg.nn.cond(c, lambda: v * 2, lambda: v - 1)
        o2 = pkg.nn.switch_case(k, [lambda: v + 1, lambda: v * 3],
                                default=lambda: v * 0 - 5)
        return o, o2, v

    jprog, prog = jstatic.Program(), static.Program()
    with jstatic.program_guard(jprog):
        jouts = build(jstatic, jstatic.data)
    with static.program_guard(prog):
        o, o2, v = build(static, static.data)
        o3 = static.nn.cond(v.sum() > 0, lambda: v + 10, lambda: v - 10)
        _, sv = static.nn.while_loop(lambda i, s: i < 3,
                                     lambda i, s: [i + 1, s * 2.0],
                                     [torch.tensor(0), v])
    jexe, exe = jstatic.Executor(), static.Executor()
    for c, k, sign in ((True, 0, 1.0), (False, 1, -1.0), (True, 9, 1.0)):
        v = np.abs(np.random.RandomState(k).randn(3)).astype(np.float32)
        feed = {'c': np.array([c]), 'v': v * sign, 'k': np.array([k])}
        want = jexe.run(jprog, feed=feed, fetch_list=list(jouts[:2]))
        got = exe.run(prog, feed=feed, fetch_list=[o, o2, o3, sv])
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **TOL)
        np.testing.assert_allclose(got[2], feed['v'] + 10 * sign, **TOL)
        np.testing.assert_allclose(got[3], feed['v'] * 8, **TOL)
    assert prog.compile_count() == 1


def test_inplace_calls_replay_on_their_own_values():
    """copy_ / masked_fill_ / __setitem__ replay in order on the replay's
    values; a buffer the program writes into is copied first, so neither
    the build-time tensors nor the buffer change."""
    buf = torch.full((2, 4), 7.0)
    prog = static.Program()
    with static.program_guard(prog):
        x = static.data('x', [2, 4], 'float32')
        scratch = torch.zeros(2, 4)
        scratch[:, :2] = x[:, :2] * 2
        scratch.masked_fill_(x > 1.0, -1.0)
        buf[:, 1:3].copy_(x[:, 1:3])
        out = scratch + buf
    built = out.detach().clone()
    exe = static.Executor()
    for seed in (1, 2):
        f = np.random.RandomState(seed).randn(2, 4).astype(np.float32) * 2
        got = exe.run(prog, feed={'x': f}, fetch_list=[out])[0]
        s = np.zeros((2, 4), np.float32)
        s[:, :2] = f[:, :2] * 2
        s[f > 1.0] = -1.0
        b = np.full((2, 4), 7.0, np.float32)
        b[:, 1:3] = f[:, 1:3]
        np.testing.assert_allclose(got, s + b, **TOL)
    # the build wrote zeros into buf eagerly; the replays did not write
    np.testing.assert_array_equal(buf[:, 1:3].numpy(), np.zeros((2, 2)))
    np.testing.assert_array_equal(out.detach().numpy(), built.numpy())


def test_print_and_py_func_replay_in_a_program(capfd):
    prog = static.Program()
    with static.program_guard(prog):
        x = static.data('x', [3], 'float32')
        y = static.Print(x * 2, message='twice')
        z = static.py_func(lambda a: np.sort(a), y, torch.zeros(3))
        out = z + 1
    capfd.readouterr()
    f = np.array([3.0, -1.0, 2.0], np.float32)
    got = static.Executor().run(prog, feed={'x': f}, fetch_list=[out])[0]
    np.testing.assert_allclose(got, np.sort(f * 2) + 1)
    assert 'twice' in capfd.readouterr().out
    with pytest.raises(ValueError, match='backward_func'):
        static.py_func(lambda a: a, torch.ones(2, requires_grad=True),
                       torch.zeros(2))
    # with backward_func the gradient flows through the host callable
    a = torch.tensor([1.0, 2.0], requires_grad=True)
    r = static.py_func(lambda v: v * v, a, torch.zeros(2),
                       backward_func=lambda v, g: 2 * v * g)
    r.sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), [2.0, 4.0])


def test_static_state_save_load_and_scope_vars(tmp_path):
    (_, _, _), (prog, x, out), lin = _build_pair(2)
    feed = np.random.RandomState(3).randn(4, 8).astype(np.float32)
    exe = static.Executor()
    want = exe.run(prog, feed={'x': feed}, fetch_list=[out])[0]
    static.save(prog, str(tmp_path / 'm'))
    blob = static.serialize_persistables([x], [out], program=prog)
    with torch.no_grad():
        for p in lin.parameters():
            p.zero_()
    # the replay reads the parameters themselves: zeros now
    np.testing.assert_array_equal(
        exe.run(prog, feed={'x': feed}, fetch_list=[out])[0], 0)
    static.load(prog, str(tmp_path / 'm'))
    np.testing.assert_allclose(
        exe.run(prog, feed={'x': feed}, fetch_list=[out])[0], want, **TOL)
    with torch.no_grad():
        lin.weight.zero_()
    static.deserialize_persistables(prog, blob)
    np.testing.assert_allclose(
        exe.run(prog, feed={'x': feed}, fetch_list=[out])[0], want, **TOL)
    state = static.load_program_state(str(tmp_path / 'm') + '.pdparams')
    assert sorted(state) == ['param_0', 'param_1']
    with torch.no_grad():
        lin.bias.zero_()
    static.set_program_state(prog, state)
    np.testing.assert_array_equal(lin.bias.detach().numpy(),
                                  state['param_1'])
    sc = static.Scope()
    with static.scope_guard(sc):
        v = static.create_global_var([2], 1.5, 'float32', name='gv')
        static.save_vars(exe, str(tmp_path))
        v.zero_()
        assert static.load_vars(exe, str(tmp_path), vars=[v])['gv'] \
            .tolist() == [1.5, 1.5]
        assert v.tolist() == [1.5, 1.5]
    path = str(tmp_path / 'raw')
    static.save_to_file(path, b'abc')
    assert static.load_from_file(path) == b'abc'


def test_fluid_surface_objects():
    assert static.cpu_places(2) == [torch.device('cpu')] * 2
    assert static.cuda_places([]) == []
    assert static.Variable is torch.Tensor
    p = static.create_parameter([3, 2], 'float32', name='w')
    assert isinstance(p, torch.nn.Parameter) and p.param_name == 'w'
    b = static.create_parameter([2], 'float32', is_bias=True)
    assert b.abs().sum().item() == 0.0
    prog = static.Program()
    assert static.CompiledProgram(prog).with_data_parallel().program is prog
    assert static.BuildStrategy().enable_inplace
    assert static.ExecutionStrategy().num_threads == 1
    pe = static.ParallelExecutor(main_program=prog)
    assert pe._exe._device() == torch.device('cpu')
    acc = static.accuracy(torch.tensor([[0.1, 0.9], [0.8, 0.2]]),
                          torch.tensor([[1], [1]]))
    assert acc.item() == 0.5
    with static.amp_guard(enable=False):
        pass
    assert static.amp is tpt.amp
    with static.name_scope('a'), static.device_guard('cpu'):
        pass
    assert static.default_main_program() is not prog
    for name in ('nn', 'Program', 'Executor', 'save_inference_model'):
        assert name in dir(static)


def test_unported_builders_name_their_queue_item():
    x = torch.zeros(1, 3, 8, 8)
    with pytest.raises(NotImplementedError, match='Queue 1 item 5'):
        static.nn.sequence_conv(x, 4)
    # deform_conv2d runs since slice 20 (vision.ops.deform_conv2d): with
    # zero offsets it is the convolution
    gen = torch.Generator().manual_seed(0)
    xr = torch.randn(1, 3, 8, 8, generator=gen)
    w = torch.randn(4, 3, 3, 3, generator=gen)
    torch.testing.assert_close(
        static.nn.deform_conv2d(xr, torch.zeros(1, 18, 6, 6), w),
        torch.nn.functional.conv2d(xr, w), rtol=1e-5, atol=1e-5)
    # nce refuses as the JAX package's does, with its message; the other
    # fluid-era builders run (against the JAX package's in
    # test_torch_static_fluid.py)
    with pytest.raises(NotImplementedError, match='superseded'):
        static.nn.nce(x, None, 4)
    assert torch.isfinite(static.nn.data_norm(torch.randn(4, 3))).all()
    # the builders whose layers the port has run (the conv and norm
    # builders against the JAX package's in test_torch_conv.py)
    for name, args in (('conv2d', (4, 3)), ('conv2d_transpose', (4,)),
                       ('batch_norm', ()), ('group_norm', (1,))):
        out = getattr(static.nn, name)(x, *args)
        assert out.shape[0] == 1 and torch.isfinite(out).all()
    out = static.nn.fc(torch.ones(2, 5), 3, activation='relu')
    assert tuple(out.shape) == (2, 3) and (out >= 0).all()
    emb = static.nn.embedding(torch.tensor([[1, 2]]), [4, 6], padding_idx=1)
    assert tuple(emb.shape) == (1, 2, 6) and emb[0, 0].abs().sum() == 0
    ln = static.nn.layer_norm(torch.randn(2, 3, 4), begin_norm_axis=1)
    np.testing.assert_allclose(ln.mean((1, 2)).detach().numpy(), 0,
                               atol=1e-6)

