"""The port's AMP (paddle_tpu_torch/amp/) against the JAX package's:
auto_cast O1 / O2 on a small GPT (the dtype each op of the path sees, in
order, and the logits), the lists and custom lists, the recompute of a
block under auto_cast, and GradScaler's state over a scripted sequence of
finite and overflowing steps."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as tpt
from paddle_tpu.framework import core as jcore
from paddle_tpu.framework.core import Tensor
from paddle_tpu.text.models.gpt import GPTConfig as JConfig
from paddle_tpu.text.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch.text.models import gpt as tgpt

# the modules (each amp package exports a function of the same name)
tac = importlib.import_module('paddle_tpu_torch.amp.auto_cast')
jac = importlib.import_module('paddle_tpu.amp.auto_cast')

SMALL = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
             max_position_embeddings=640, dropout=0.0)
# the ops of the GPT path that cast, by their names in the JAX package
PATH_OPS = {'linear', 'embedding', 'layer_norm', 'gelu', 'dropout',
            'softmax', 'sdpa', 'flash_attention', 'linear_cross_entropy',
            'cross_entropy'}


@pytest.fixture(scope='module')
def pair():
    paddle.seed(21)
    jm = JGPT(JConfig(**SMALL))
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**SMALL), device='cpu')
    tgpt.load_paddle_tpu_state(tm, {k: np.asarray(v.numpy())
                                    for k, v in jm.state_dict().items()})
    return jm, tm


def _dt(x):
    return str(x.dtype).split('.')[-1]


def _jax_run(jm, ids, labels, **amp):
    seen = []
    hook = jcore._amp_cast_hook[0]

    def record(name, arrays):
        out = hook(name, arrays)
        if name in PATH_OPS:
            seen.append((name, tuple(_dt(a) for a in out)))
        return out

    jcore._amp_cast_hook[0] = record
    try:
        with paddle.amp.auto_cast(**amp):
            logits = jm(paddle.to_tensor(ids))
            loss = jm.loss(logits, paddle.to_tensor(labels))
    finally:
        jcore._amp_cast_hook[0] = hook
    return seen, np.asarray(logits._data.astype(jnp.float32)), \
        float(np.asarray(loss._data.astype(jnp.float32)))


def _record_casts(monkeypatch):
    """The (op name, input dtypes) of each cast the port's functionals make
    under auto_cast, in order."""
    seen = []
    inner = tac.amp_cast_inputs

    def record(name, tensors):
        out = inner(name, tensors)
        seen.append((name, tuple(_dt(t) for t in out if t is not None)))
        return out

    monkeypatch.setattr(tac, 'amp_cast_inputs', record)
    return seen


def _torch_run(tm, ids, labels, monkeypatch, **amp):
    seen = _record_casts(monkeypatch)
    with tpt.amp.auto_cast(**amp):
        logits = tm(torch.from_numpy(ids))
        loss = tm.loss(logits, torch.from_numpy(labels))
    monkeypatch.undo()
    return seen, logits.detach().float().numpy(), loss.item()


@pytest.mark.parametrize('level,dtype', [('O1', 'bfloat16'),
                                         ('O1', 'float16'),
                                         ('O2', 'bfloat16'),
                                         ('O2', 'float16')])
def test_auto_cast_gpt_matches_jax(pair, level, dtype, monkeypatch):
    jm, tm = pair
    jm.train()
    tm.train()
    rng = np.random.RandomState(3)
    ids = rng.randint(0, SMALL['vocab_size'], (2, 64))
    labels = rng.randint(0, SMALL['vocab_size'], (2, 64))
    want_seen, want_logits, want_loss = _jax_run(jm, ids, labels,
                                                 level=level, dtype=dtype)
    got_seen, got_logits, got_loss = _torch_run(tm, ids, labels, monkeypatch,
                                                level=level, dtype=dtype)
    assert got_seen == want_seen
    if level == 'O1':
        # linear in the AMP dtype; attention, norms and the loss in f32
        assert ('sdpa', ('float32',) * 3) in got_seen
        assert ('linear', (dtype,) * 3) in got_seen
    else:
        assert ('sdpa', (dtype,) * 3) in got_seen
        assert ('layer_norm', ('float32',) * 3) in got_seen
    # 16-bit products summed in another order: a few 16-bit ulps of the
    # largest logit
    scale = np.abs(want_logits).max()
    assert np.abs(got_logits - want_logits).max() <= 3e-2 * scale
    np.testing.assert_allclose(got_loss, want_loss, rtol=2e-2)


def test_auto_cast_flash_route_casts_as_flash_attention(monkeypatch):
    # at 512 tokens the attention takes the flash route, whose JAX op name
    # is 'flash_attention'; under O1 it runs in f32
    seen = _record_casts(monkeypatch)
    q = torch.randn(1, 512, 2, 64).bfloat16()
    with tpt.amp.auto_cast(level='O1', dtype='bfloat16'):
        out = tpt.nn.functional.scaled_dot_product_attention(
            q, q, q, is_causal=True)
    assert seen == [('flash_attention', ('float32',) * 3)]
    assert out.dtype == torch.float32


def test_lists_custom_lists_and_state():
    assert tac.WHITE_LIST == jac.WHITE_LIST
    assert tac.BLACK_LIST == jac.BLACK_LIST
    x = torch.ones(2, dtype=torch.bfloat16)
    with tpt.amp.auto_cast(custom_white_list=['gelu'],
                           custom_black_list=['linear'], dtype='bfloat16'):
        assert 'gelu' in tac.white_list() and 'linear' in tac.black_list()
        assert tac.cast('gelu', x.float())[0].dtype == torch.bfloat16
        assert tac.cast('linear', x)[0].dtype == torch.float32
        with tpt.amp.amp_guard(enable=False):
            assert tac.cast('linear', x)[0] is x
    assert not tac.amp_state()['enabled']
    with pytest.raises(TypeError):
        with tpt.amp.auto_cast(dtype='int8'):
            pass
    assert not tac.amp_state()['enabled']  # a refused dtype changes nothing


def test_recompute_replays_the_forward_casts(pair):
    """A block recomputed in the backward, after the auto_cast context has
    closed, casts as its forward did: the same grads as without
    recompute."""
    _, tm = pair
    tm.train()
    ids = torch.from_numpy(np.random.RandomState(4).randint(0, 512, (2, 64)))
    grads = []
    for flag in (False, True):
        tm.gpt.enable_recompute(flag)
        with tpt.amp.auto_cast(level='O1', dtype='bfloat16'):
            loss = tm.loss(tm(ids), ids)
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in tm.named_parameters()})
        tm.zero_grad(set_to_none=True)
    tm.gpt.enable_recompute(False)
    for name, g in grads[0].items():
        assert torch.equal(grads[1][name], g), name


# finite (True) or overflowing (False) steps; growth every 3 finite steps
SCRIPT = [False, False, True, True, True, True, False, True, True, True,
          True, False, False, True]


def test_grad_scaler_state_matches_jax():
    jp = paddle.create_parameter([3], 'float32')
    jp._data = jnp.ones(3)
    tp = torch.ones(3, requires_grad=True)
    jopt = paddle.optimizer.SGD(learning_rate=0.1, parameters=[jp])
    topt = tpt.optimizer.SGD(learning_rate=0.1, parameters=[tp])
    kw = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=3,
              decr_every_n_nan_or_inf=1)
    js, ts = paddle.amp.GradScaler(**kw), tpt.amp.GradScaler(**kw)
    for i, finite in enumerate(SCRIPT):
        g = np.array([0.5, -1.0, 2.0], np.float32) * js._scale
        if not finite:
            g[1] = np.inf
        jp.grad = Tensor(jnp.asarray(g))
        tp.grad = torch.tensor(g)
        js.step(jopt)
        js.update()
        ts.step(topt)
        ts.update()
        assert ts.state_dict() == js.state_dict(), i
        assert ts._found_inf == (not finite)
        np.testing.assert_array_equal(tp.detach().numpy(),
                                      np.asarray(jp._data))
    state = ts.state_dict()
    fresh = tpt.amp.GradScaler()
    fresh.load_state_dict(state)
    assert fresh.state_dict() == state
    assert tpt.amp.AmpScaler is tpt.amp.GradScaler


def test_eager_fp16_loop_skips_overflow_and_trains(pair):
    """The eager loop: O2 fp16 under auto_cast, GradScaler, clip and a
    scheduler. A scale too large for fp16 overflows: the step is skipped
    (parameters unchanged) and the scale halved until the steps train."""
    _, tm = pair
    model = tgpt.GPTForCausalLM(tgpt.GPTConfig(**SMALL), device='cpu')
    model.load_state_dict(tm.state_dict())
    model.train()
    sched = tpt.optimizer.lr.LinearWarmup(1e-3, 2, 1e-4, 1e-3)
    opt = tpt.optimizer.AdamW(sched, parameters=model.named_parameters(),
                              grad_clip=tpt.nn.ClipGradByGlobalNorm(1.0))
    # the loss is f32 here (cross_entropy is black-listed); the logits'
    # fp16 cotangent, up to scale / 128, overflows from 2^23 up
    scaler = tpt.amp.GradScaler(init_loss_scaling=2.0 ** 24)
    ids = torch.from_numpy(np.random.RandomState(5).randint(0, 512, (2, 64)))
    scales, losses, skips = [], [], []
    for _ in range(8):
        before = model.gpt.wte.weight.detach().clone()
        with tpt.amp.auto_cast(level='O2', dtype='float16'):
            loss = model.loss(model(ids), ids)
        scaler.scale(loss).backward()
        scaler.step(opt)
        skipped = scaler._found_inf
        scaler.update()
        opt.clear_grad()
        sched.step()
        scales.append(scaler._scale)
        losses.append(loss.item())
        skips.append(skipped)
        if skipped:
            assert torch.equal(model.gpt.wte.weight, before)
        else:
            assert not torch.equal(model.gpt.wte.weight, before)
    # a run of skips, each halving the scale, then every step trains
    n = skips.index(False)
    assert n >= 1 and not any(skips[n:])
    assert scales[:n] == [2.0 ** (23 - i) for i in range(n)]
    assert scales[-1] == scales[n - 1]
    assert losses[-1] < losses[n]
