"""The port's training slices against the JAX package's: a small GPT built
in JAX, carried across with load_paddle_tpu_state, trained through
TrainStep on both sides, with AdamW and with the recipe users configure
(a warm-up into cosine schedule, global-norm clipping, decay off biases
and norms) under each TrainStep option: AMP in bf16 and in fp16 with
dynamic loss scaling, whole-step remat, per-block recompute, gradient
merge and multi_step. The JAX step runs its Pallas flash kernels (forward
and backward) through the interpreter under strict mode; the port takes
the kernels' plain versions on the CPU, and its route counters show which
backward ran."""
import types

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as tpt
from paddle_tpu.framework import functional as jfm
from paddle_tpu.text.models.gpt import GPTConfig as JConfig
from paddle_tpu.text.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch.framework.functional import TrainStep
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.text.models import gpt as tgpt

SMALL = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
             max_position_embeddings=1024, dropout=0.0)
LR = 1e-3
# the update's distance from the JAX step's update, over the model and for
# the worst parameter (_update_errors), by whether the run is f32
UPDATE_TOL = {True: (2e-3, 1e-3), False: (0.15, 0.25)}


@pytest.fixture(autouse=True)
def _interpret_strict(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_FLASH_INTERPRET', '1')
    monkeypatch.setenv('PADDLE_TPU_FLASH_STRICT', '1')


def _pair(seed, **cfg):
    cfg = dict(SMALL, **cfg)
    paddle.seed(seed)
    jm = JGPT(JConfig(**cfg))
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**cfg), device='cpu')
    tgpt.load_paddle_tpu_state(tm, {k: np.asarray(v.numpy())
                                    for k, v in jm.state_dict().items()})
    return jm, tm


def _batch(b, n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, SMALL['vocab_size'], (b, n)).astype(np.int32),
            rng.randint(0, SMALL['vocab_size'], (b, n)).astype(np.int32))


def _jax_loss_and_grads(jm, ids, labels):
    bufs = jfm.extract_buffers(jm)

    def f(params):
        loss, _ = jfm.functional_call(
            jm, params, bufs, args=(jax.numpy.asarray(ids),), training=True,
            post_fn=jfm.make_loss_post(lambda o, l: jm.loss(o, l),
                                       (jax.numpy.asarray(labels),)))
        return loss

    loss, grads = jax.jit(jax.value_and_grad(f))(jfm.extract_params(jm))
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def _torch_loss_and_grads(tm, ids, labels):
    tm.train()
    loss = tm.loss(tm(torch.from_numpy(ids).long()),
                   torch.from_numpy(labels).long())
    loss.backward()
    grads = {k: p.grad.numpy().copy() for k, p in tm.named_parameters()}
    tm.zero_grad(set_to_none=True)
    return loss.item(), grads


def _assert_grads_close(got, want):
    # f32 on both sides, summed in another order through 2 layers: each
    # gradient within 1e-4 of its largest entry
    assert set(got) == set(want)
    for name, w in want.items():
        scale = max(np.abs(w).max(), 1e-6)
        err = np.abs(got[name] - w).max()
        assert err <= 1e-4 * scale, (name, err, scale)


def _train(jm, tm, batches):
    jopt = paddle.optimizer.AdamW(learning_rate=LR,
                                  parameters=jm.parameters())
    jstep = jfm.TrainStep(jm, lambda o, l: jm.loss(o, l), jopt)
    tstep = TrainStep(tm, tm.loss, AdamW(learning_rate=LR,
                                         parameters=tm.parameters()))
    losses = []
    for ids, labels in batches:
        want = float(np.asarray(jstep(paddle.to_tensor(ids),
                                      paddle.to_tensor(labels)).numpy()))
        got = tstep(torch.from_numpy(ids).long(),
                    torch.from_numpy(labels).long()).item()
        losses.append((got, want))
    return losses


def _assert_params_close(jm, tm, steps, lr=LR, f32=True, init=None):
    # Adam moves every parameter by ~lr a step whatever the size of its
    # gradient, so where a gradient is ~0 (the key third of each qkv bias,
    # whose exact gradient is 0) the two sides may move opposite ways: no
    # entry apart by more than 2 lr a step, and, over the whole model (in
    # f32), almost all within f32 rounding of each other. Given the
    # parameters both sides started from (`init`), the updates themselves
    # are held together too (_assert_updates_close), which in 16-bit runs
    # takes the place of the f32 closeness count.
    want = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    close = total = 0
    for name, p in tm.state_dict().items():
        diff = np.abs(p.float().numpy() - want[name])
        assert diff.max() <= 2 * lr * steps + 1e-6, (name, diff.max())
        close += int(np.sum(diff <= 1e-5 + 1e-4 * np.abs(want[name])))
        total += diff.size
    if f32:
        assert close >= 0.999 * total, (close, total)
    if init is not None:
        _assert_updates_close(init, want, tm, f32)


def _update_errors(init, want, tm):
    """How far the port's update is from the JAX step's, both taken from
    the same start (`init`, by parameter name): ||d_port - d_jax|| /
    ||d_jax|| over the parameters of `init`, and the largest such ratio
    over those parameters, each qkv bias without its key third (whose
    exact gradient is 0, so Adam moves it by ~lr in whatever direction
    rounding gives)."""
    num = den = worst = 0.0
    port = tm.state_dict()
    for name, start in init.items():
        d_jax = want[name].astype(np.float64) - start
        d_port = port[name].float().numpy().astype(np.float64) - start
        assert np.any(d_jax != 0), ('the JAX step did not move', name)
        num += np.sum((d_port - d_jax) ** 2)
        den += np.sum(d_jax ** 2)
        if name.endswith('attn.qkv_proj.bias'):
            third = d_jax.size // 3
            keep = np.r_[0:third, 2 * third:3 * third]
            d_jax, d_port = d_jax[keep], d_port[keep]
        worst = max(worst, np.linalg.norm(d_port - d_jax) /
                    np.linalg.norm(d_jax))
    return np.sqrt(num / den), worst


def _assert_updates_close(init, want, tm, f32):
    # (over the model, the worst parameter). A skipped update reads 1 on
    # both, a negated one 2. Sound runs of the cases here read at most
    # 3.3e-4 / 7.3e-5 in f32 and 0.060 / 0.100 in bf16 / fp16
    tol = UPDATE_TOL[f32]
    model, worst = _update_errors(init, want, tm)
    assert model <= tol[0] and worst <= tol[1], (model, worst, tol)


def _state(tm):
    return {k: v.float().numpy().astype(np.float64).copy()
            for k, v in tm.state_dict().items()}


def test_train_fused_loss_seq512_matches_jax():
    jm, tm = _pair(11, fused_loss=True)
    ids, labels = _batch(2, 512, 0)
    before = dict(tfa.counts)
    got_loss, got = _torch_loss_and_grads(tm, ids, labels)
    # one flash forward and one fused backward per layer
    assert tfa.counts['flash'] == before['flash'] + SMALL['num_layers']
    assert tfa.counts['bwd_fused'] == \
        before['bwd_fused'] + SMALL['num_layers']
    assert tfa.counts['bwd_two_pass'] == before['bwd_two_pass']
    want_loss, want = _jax_loss_and_grads(jm, ids, labels)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    _assert_grads_close(got, want)

    batches = [_batch(2, 512, s) for s in (1, 2, 1)]
    losses = _train(jm, tm, batches)
    for got_l, want_l in losses:
        np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    assert losses[2][0] < losses[0][0]  # the repeated batch learned
    _assert_params_close(jm, tm, 3)


def test_train_unfused_loss_step_matches_jax():
    jm, tm = _pair(12, fused_loss=False)
    ids, labels = _batch(2, 512, 3)
    got_loss, got = _torch_loss_and_grads(tm, ids, labels)
    want_loss, want = _jax_loss_and_grads(jm, ids, labels)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    _assert_grads_close(got, want)
    (got_l, want_l), = _train(jm, tm, [(ids, labels)])
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    _assert_params_close(jm, tm, 1)


def test_train_seq1024_takes_the_two_pass_backward():
    jm, tm = _pair(13, fused_loss=True)
    ids, labels = _batch(1, 1024, 4)
    before = dict(tfa.counts)
    (got_l, want_l), = _train(jm, tm, [(ids, labels)])
    assert tfa.counts['bwd_two_pass'] == \
        before['bwd_two_pass'] + SMALL['num_layers']
    assert tfa.counts['bwd_fused'] == before['bwd_fused']
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    _assert_params_close(jm, tm, 1)


def test_train_seq2048_long_route_matches_jax(monkeypatch):
    # slice 3: long-context training, with both packages forced onto their
    # long path at 2048 tokens (the JAX long kernels run 512 x 1024 blocks
    # through the interpreter; the port takes their plain versions)
    monkeypatch.setenv('PADDLE_TPU_FLASH_FORCE_LONG', '1')
    monkeypatch.setattr(tfa, 'LONG_SEQ', 2048)
    jm, tm = _pair(17, fused_loss=True, max_position_embeddings=2048)
    ids, labels = _batch(1, 2048, 6)
    before = dict(tfa.counts)
    got_loss, got = _torch_loss_and_grads(tm, ids, labels)
    layers = SMALL['num_layers']
    assert tfa.counts['fwd_long'] == before['fwd_long'] + layers
    assert tfa.counts['bwd_long'] == before['bwd_long'] + layers
    for route in ('flash', 'bwd_fused', 'bwd_two_pass', 'rejected'):
        assert tfa.counts[route] == before[route], route
    want_loss, want = _jax_loss_and_grads(jm, ids, labels)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    _assert_grads_close(got, want)

    (got_l, want_l), = _train(jm, tm, [(ids, labels)])
    assert tfa.counts['bwd_long'] == before['bwd_long'] + 2 * layers
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    _assert_params_close(jm, tm, 1)


def test_untied_rmsnorm_model_carries_across_and_trains():
    jm, tm = _pair(14, tie_word_embeddings=False, use_rmsnorm=True,
                   fused_loss=True)
    assert 'lm_head.weight' in dict(tm.named_parameters())
    assert tm.num_params() == jm.num_params()
    assert tm.flops_per_token(512) == jm.flops_per_token(512)
    ids, labels = _batch(2, 512, 5)
    got_loss, got = _torch_loss_and_grads(tm, ids, labels)
    want_loss, want = _jax_loss_and_grads(jm, ids, labels)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    _assert_grads_close(got, want)


def test_fused_forward_contract_and_config_checks():
    _, tm = _pair(15, fused_loss=True)
    ids = torch.zeros(1, 8).long()
    tm.train()
    assert tm(ids).shape == (1, 8, SMALL['hidden_size'])  # hidden state
    tm.eval()
    assert tm(ids).shape == (1, 8, SMALL['vocab_size'])  # logits
    with pytest.raises(ValueError, match='vocab_size != hidden_size'):
        tgpt.GPTConfig(vocab_size=64, hidden_size=64, fused_loss=True)
    b = tgpt.GPTConfig.bert_base_equiv()
    jb = JConfig.bert_base_equiv()
    for key in ('vocab_size', 'hidden_size', 'num_layers', 'num_heads',
                'max_position_embeddings', 'initializer_range'):
        assert getattr(b, key) == getattr(jb, key), key
    # MoE blocks build (they raised before the pipeline / MoE slice);
    # under recompute a training forward raises, as in the JAX package
    moe = tgpt.GPTForCausalLM(tgpt.GPTConfig(**SMALL, num_experts=2,
                                             recompute=True), device='cpu')
    moe.train()
    with pytest.raises(NotImplementedError, match='MoE'):
        moe(ids)
    # per-block recompute builds (it raised before the training slice)
    rc = tgpt.GPTForCausalLM(tgpt.GPTConfig(**SMALL, recompute=True),
                             device='cpu')
    assert rc.gpt._recompute
    rc.enable_recompute(False)
    assert not rc.gpt._recompute
    # the pipeline split composes to the fused training loss
    pre, blocks, post = tm.pp_decompose()
    tm.train()
    x = pre(ids)
    for block in blocks:
        x = block(x)
    torch.testing.assert_close(post(x, ids), tm.loss(tm(ids), ids))


# each package's modules, for optimizers built per package
J = types.SimpleNamespace(opt=paddle.optimizer, nn=paddle.nn)
T = types.SimpleNamespace(opt=tpt.optimizer, nn=tpt.nn)
PEAK_LR = 6e-4


def _decays(name):
    # GPT-3's recipe decays the matrices, not the biases and norms
    return name.endswith('.weight') and '.ln_' not in name and \
        not name.startswith('gpt.ln_f')


def _recipe(pkg, model):
    """AdamW (0.9, 0.95), weight decay 0.1 off biases and norms, global
    norm clip 1.0, LinearWarmup into CosineAnnealingDecay. The JAX
    parameters take their model names, which the port reads from
    named_parameters()."""
    sched = pkg.opt.lr.LinearWarmup(pkg.opt.lr.CosineAnnealingDecay(
        PEAK_LR, 10, eta_min=PEAK_LR / 10), 2, 0.0, PEAK_LR)
    if pkg is J:
        for name, p in model.named_parameters():
            p.name = name
        params = model.parameters()
    else:
        params = model.named_parameters()
    return pkg.opt.AdamW(sched, beta1=0.9, beta2=0.95, epsilon=1e-8,
                         weight_decay=0.1, apply_decay_param_fun=_decays,
                         grad_clip=pkg.nn.ClipGradByGlobalNorm(1.0),
                         parameters=params), sched


def _plain(pkg, model):
    return pkg.opt.AdamW(learning_rate=LR,
                         parameters=model.parameters()), None


def _run(seed, make_opt, step_kw, batches, cfg=None, observe=None,
         embed_gain=1):
    """Both TrainSteps over `batches` (the schedulers stepped after each
    call); returns the models, the steps, the (port, JAX) losses and the
    parameters both started from."""
    jm, tm = _pair(seed, **(cfg or {}))
    if embed_gain != 1:
        for jl, tl in ((jm.gpt.wte, tm.gpt.wte), (jm.gpt.wpe, tm.gpt.wpe)):
            jl.weight._data = jl.weight._data * embed_gain
            with torch.no_grad():
                tl.weight.mul_(embed_gain)
    init = _state(tm)
    jopt, jsched = make_opt(J, jm)
    topt, tsched = make_opt(T, tm)
    # a step option given as a function of the package is built per side
    make = step_kw.get('pp_state')
    if callable(make):
        jstep = jfm.TrainStep(jm, lambda o, l: jm.loss(o, l), jopt, **make(J))
        tstep = TrainStep(tm, tm.loss, topt, **make(T))
    else:
        jstep = jfm.TrainStep(jm, lambda o, l: jm.loss(o, l), jopt,
                              **step_kw)
        tstep = TrainStep(tm, tm.loss, topt, **step_kw)
    losses = []
    for ids, labels in batches:
        want = float(np.asarray(jstep(paddle.to_tensor(ids),
                                      paddle.to_tensor(labels)).numpy()))
        got = tstep(torch.from_numpy(ids).long(),
                    torch.from_numpy(labels).long()).item()
        losses.append((got, want))
        if observe is not None:
            observe(jstep, tstep)
        for sched in (jsched, tsched):
            if sched is not None:
                sched.step()
    return jm, tm, jstep, tstep, losses, init


def _check_losses(losses, rtol):
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=rtol)


def _halve_grads(grads):
    # a grad_sync hook both packages take: {name: grad} -> {name: grad}
    return {name: g * 0.5 for name, g in grads.items()}


def _pp_state_kw(pkg):
    """A one-stage pipeline of 2 microbatches, as each package builds
    it (the JAX package's over a one-device 'pp' mesh)."""
    if pkg is J:
        from jax.sharding import Mesh
        from paddle_tpu.distributed.pipeline import make_pp_state
        return {'pp_state': make_pp_state(
            Mesh(np.asarray(jax.devices()[:1]), ('pp',)), 1, n_micro=2)}
    from paddle_tpu_torch.distributed.pipeline import make_pp_state
    return {'pp_state': make_pp_state(None, 1, n_micro=2)}


# These options raised NotImplementedError until a slice ported them
# (k_steps, amp_dtype, remat: the training slice; grad_sync: the
# collective slice; pp_state: the pipeline slice); each of those cases
# now holds the port to the JAX TrainStep with it.
@pytest.mark.parametrize('kwargs', [{'k_steps': 2}, {'amp_dtype': 'bfloat16'},
                                    {'remat': True},
                                    {'pp_state': _pp_state_kw},
                                    {'grad_sync': _halve_grads}])
def test_train_step_unported_options_raise(kwargs):
    # with the recipe's optimizer: its schedule, clip and decay groups
    batches = [_batch(2, 64, s) for s in (30, 31, 30, 31)]
    jm, tm, jstep, tstep, losses, init = _run(16, _recipe, kwargs, batches)
    amp = 'amp_dtype' in kwargs
    _check_losses(losses, 2e-2 if amp else 1e-5)
    updates = 2 if 'k_steps' in kwargs else 4
    assert tstep.optimizer._step_count == updates == \
        int(jstep.optimizer._step_count)
    _assert_params_close(jm, tm, updates, lr=PEAK_LR, f32=not amp,
                         init=init)


@pytest.mark.parametrize('option', ['f32', 'recompute', 'k_steps_sum'])
def test_recipe_train_step_matches_jax(option):
    """The recipe through TrainStep, seq 64: in f32, with per-block
    recompute, and with summed (not averaged) bf16 gradient merge; the
    cases above take k_steps, bf16 AMP and remat one at a time."""
    step_kw = {'k_steps_sum': {'k_steps': 2, 'grad_merge_avg': False,
                               'amp_dtype': 'bfloat16'}}.get(option, {})
    cfg = {'recompute': True} if option == 'recompute' else None
    batches = [_batch(2, 64, s) for s in (40, 41, 40, 41)]
    jm, tm, jstep, tstep, losses, init = _run(18, _recipe, step_kw, batches,
                                              cfg)
    amp = 'amp_dtype' in step_kw
    _check_losses(losses, 2e-2 if amp else 1e-5)
    updates = 2 if 'k_steps' in step_kw else 4
    assert tstep.optimizer._step_count == updates == \
        int(jstep.optimizer._step_count)
    _assert_params_close(jm, tm, updates, lr=PEAK_LR, f32=not amp,
                         init=init)
    if option == 'recompute':
        assert tm.gpt._recompute


def test_fp16_loss_scaling_matches_jax():
    """fp16 AMP from a scale too large for fp16: the same steps skip on
    both sides (parameters, slots and step count untouched), the scale
    halves on each and doubles after ls_growth_interval finite steps, and
    the losses agree. From 2^16 up the fp16 loss's own cotangent
    overflows in both packages. The embeddings are scaled by 8 (exactly):
    at their initial size the JAX package's layer_norm, composed of fp16
    ops, overflows its variance's cotangent at 2^15, where torch's fused
    layer_norm computes in f32."""
    trace = []

    def observe(jstep, tstep):
        trace.append(((tstep.loss_scale, tstep.optimizer._step_count),
                      (float(jstep._ls_scale),
                       int(jstep.optimizer._step_count))))

    batches = [_batch(2, 64, s) for s in range(50, 58)]
    jm, tm, _, _, losses, init = _run(
        19, _plain, {'amp_dtype': 'float16', 'init_loss_scaling': 2.0 ** 18,
                     'ls_growth_interval': 2}, batches, observe=observe,
        embed_gain=8)
    got, want = zip(*trace)
    assert got == want
    steps = [s for _, s in got]
    assert steps[0] == 0 and steps[-1] > 0  # skipped first, then trained
    assert any(b[0] > a[0] for a, b in zip(got, got[1:]))  # a doubling
    _check_losses(losses, 2e-2)
    _assert_params_close(jm, tm, steps[-1], f32=False, init=init)


def _frozen_net(pkg, **device):
    """Linear (its weight frozen by ParamAttr) -> LayerNorm -> Linear, as a
    layer of the package `pkg`."""
    base = paddle.nn.Layer if pkg is paddle else torch.nn.Module

    class Net(base):
        def __init__(self):
            super().__init__()
            self.fc1 = pkg.nn.Linear(
                6, 8, weight_attr=pkg.ParamAttr(trainable=False), **device)
            self.norm = pkg.nn.LayerNorm(8, **device)
            self.fc2 = pkg.nn.Linear(8, 4, **device)

        def forward(self, x):
            return self.fc2(self.norm(self.fc1(x)))

    return Net()


@pytest.mark.parametrize('amp_dtype', ['bfloat16', 'float16'])
def test_amp_casts_frozen_parameters_as_jax(amp_dtype):
    """Under AMP the JAX step casts every parameter, a frozen one too: the
    frozen f32 weight meets the 16-bit activations in the AMP dtype, keeps
    its f32 value, and the trainable ones take the JAX step's update."""
    paddle.seed(23)
    jnet = _frozen_net(paddle)
    tnet = _frozen_net(tpt, device='cpu')
    tnet.load_state_dict({k: torch.tensor(np.asarray(v.numpy()))
                          for k, v in jnet.state_dict().items()})
    assert not tnet.fc1.weight.requires_grad and \
        tnet.fc1.weight.trainable is False
    init = _state(tnet)
    frozen = init.pop('fc1.weight')

    def loss(o, y):
        return ((o - y) ** 2).mean()

    jstep = jfm.TrainStep(jnet, loss, paddle.optimizer.AdamW(
        learning_rate=1e-2, parameters=jnet.parameters()),
        amp_dtype=amp_dtype)
    tstep = TrainStep(tnet, loss, AdamW(learning_rate=1e-2,
                                        parameters=tnet.parameters()),
                      amp_dtype=amp_dtype)
    rng = np.random.RandomState(24)
    for _ in range(3):
        x = rng.randn(16, 6).astype(np.float32)
        y = rng.randn(16, 4).astype(np.float32)
        want = float(np.asarray(jstep(paddle.to_tensor(x),
                                      paddle.to_tensor(y)).numpy()))
        got = tstep(torch.tensor(x), torch.tensor(y)).item()
        np.testing.assert_allclose(got, want, rtol=2e-2)
    want = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    for side in (want['fc1.weight'], tnet.fc1.weight.detach().numpy()):
        assert side.dtype == np.float32
        np.testing.assert_array_equal(side, frozen)
    assert tnet.fc1.weight.grad is None
    _assert_updates_close(init, want, tnet, f32=False)


def test_fp16_with_k_steps_raises_and_no_program():
    _, tm = _pair(20)
    with pytest.raises(NotImplementedError, match='gradient merge'):
        TrainStep(tm, tm.loss, AdamW(parameters=tm.parameters()),
                  amp_dtype='float16', k_steps=2)
    step = TrainStep(tm, tm.loss, AdamW(parameters=tm.parameters()))
    for name in ('trace_jaxpr', 'compiled_executable', 'compiled_hlo'):
        with pytest.raises(NotImplementedError, match='no XLA program'):
            getattr(step, name)(None, None)


def test_multi_step_equals_steps_and_jax():
    """multi_step(K=3) runs K steps at one learning rate: the same losses
    and parameters as three calls, and as the JAX multi_step."""
    batches = [_batch(2, 64, s) for s in (60, 61, 62)]
    ids = np.stack([b[0] for b in batches])
    labels = np.stack([b[1] for b in batches])
    jm, tm = _pair(21)
    _, tm2 = _pair(21)
    jstep = jfm.TrainStep(jm, lambda o, l: jm.loss(o, l), _recipe(J, jm)[0])
    tstep = TrainStep(tm, tm.loss, _recipe(T, tm)[0])
    tstep2 = TrainStep(tm2, tm2.loss, _recipe(T, tm2)[0])
    for opt in (jstep.optimizer, tstep.optimizer, tstep2.optimizer):
        opt._lr.step()
        opt._lr.step()  # past the warm-up's zero rate
    want = np.asarray(jstep.multi_step(paddle.to_tensor(ids),
                                       paddle.to_tensor(labels)).numpy())
    got = tstep.multi_step(torch.from_numpy(ids).long(),
                           torch.from_numpy(labels).long())
    one_by_one = [tstep2(torch.from_numpy(i).long(),
                         torch.from_numpy(l).long()) for i, l in batches]
    assert torch.equal(got, torch.stack(one_by_one))
    for name, p in tm.state_dict().items():
        assert torch.equal(p, tm2.state_dict()[name]), name
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    _assert_params_close(jm, tm, 3, lr=PEAK_LR)


def test_slice_recipe_seq512_amp_remat_k_steps_matches_jax():
    """The slice as a whole at the flash shape: the recipe with bf16 AMP,
    whole-step remat and k_steps=2, two updates, against the JAX TrainStep
    running its Pallas kernels through the interpreter. The port's
    forward runs twice a micro-step under remat."""
    batches = [_batch(2, 512, s) for s in (70, 71, 70, 71)]
    before = dict(tfa.counts)
    jm, tm, jstep, tstep, losses, init = _run(
        22, _recipe, {'amp_dtype': 'bfloat16', 'remat': True,
                      'k_steps': 2}, batches)
    layers = SMALL['num_layers']
    assert tfa.counts['flash'] - before['flash'] == 2 * layers * 4
    assert tfa.counts['bwd_fused'] - before['bwd_fused'] == layers * 4
    assert tfa.counts['rejected'] == before['rejected']
    _check_losses(losses, 2e-2)
    assert tstep.optimizer._step_count == 2 == \
        int(jstep.optimizer._step_count)
    _assert_params_close(jm, tm, 2, lr=PEAK_LR, f32=False, init=init)
