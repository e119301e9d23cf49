"""The port's training slice against the JAX package's: a small GPT built
in JAX, carried across with load_paddle_tpu_state, trained with AdamW
through TrainStep on both sides. The JAX step runs its Pallas flash
kernels (forward and backward) through the interpreter under strict mode;
the port takes the kernels' plain versions on the CPU, and its route
counters show which backward ran."""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
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


def _assert_params_close(jm, tm, steps):
    # Adam moves every parameter by ~lr a step whatever the size of its
    # gradient, so where a gradient is ~0 (the key third of each qkv bias,
    # whose exact gradient is 0) the two sides may move opposite ways: no
    # entry apart by more than 2 lr a step, and, over the whole model,
    # almost all within f32 rounding of each other
    want = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    close = total = 0
    for name, p in tm.state_dict().items():
        diff = np.abs(p.numpy() - want[name])
        assert diff.max() <= 2 * LR * steps, (name, diff.max())
        close += int(np.sum(diff <= 1e-5 + 1e-4 * np.abs(want[name])))
        total += diff.size
    assert close >= 0.999 * total, (close, total)


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
    with pytest.raises(NotImplementedError, match='MoE'):
        tgpt.GPTForCausalLM(tgpt.GPTConfig(**SMALL, num_experts=2),
                            device='cpu')
    with pytest.raises(NotImplementedError, match='recompute'):
        tgpt.GPTForCausalLM(tgpt.GPTConfig(**SMALL, recompute=True),
                            device='cpu')
    with pytest.raises(NotImplementedError, match='pipeline'):
        tm.pp_decompose()


@pytest.mark.parametrize('kwargs', [{'k_steps': 2}, {'amp_dtype': 'bfloat16'},
                                    {'remat': True}, {'mesh': object()},
                                    {'grad_sync': lambda g: g}])
def test_train_step_unported_options_raise(kwargs):
    _, tm = _pair(16)
    with pytest.raises(NotImplementedError, match='not ported'):
        TrainStep(tm, tm.loss, AdamW(parameters=tm.parameters()), **kwargs)
