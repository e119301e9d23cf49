"""The port's transformer layers (paddle_tpu_torch/nn/layer/transformer.py)
against the JAX package's: the unmasked encoder at 512 tokens on the flash
route (the JAX side runs its Pallas kernels through the interpreter under
strict mode, the port the kernels' plain versions on the CPU), bool and
float masks on the plain path, MultiHeadAttention's two caches, the
encoder-decoder Transformer with its causal mask, and the ParamAttr
metadata of the layers TransformerEncoder / TransformerDecoder copy."""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.framework import functional as jfm
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.ops import flash_attention as tfa


@pytest.fixture(autouse=True)
def _interpret_strict(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_FLASH_INTERPRET', '1')
    monkeypatch.setenv('PADDLE_TPU_FLASH_STRICT', '1')


def _carry(jm, tm):
    want = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    assert set(want) == set(tm.state_dict())
    tm.load_state_dict({k: torch.tensor(v) for k, v in want.items()})
    return tm


def _jax_out(jm, *args):
    jm.eval()
    out = jm(*[paddle.to_tensor(a) if isinstance(a, np.ndarray) else a
               for a in args])
    return np.asarray(out.numpy())


def _port_out(tm, *args):
    tm.eval()
    with torch.no_grad():
        return tm(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                    for a in args]).numpy()


def test_unmasked_encoder_at_512_matches_jax_on_flash():
    """One encoder layer (hidden 128, 2 heads, gelu, no dropout) on 512
    tokens without a mask: the flash forward and the fused backward on
    both sides; output, input and parameter gradients within 1e-4 of
    their largest entries."""
    n, h = 512, 128
    rng = np.random.RandomState(0)
    src = rng.randn(1, n, h).astype(np.float32)
    target = rng.randn(1, n, h).astype(np.float32)
    paddle.seed(0)
    jm = jnn.TransformerEncoder(jnn.TransformerEncoderLayer(
        h, 2, 256, dropout=0.0, activation='gelu'), 1)
    tm = _carry(jm, tnn.TransformerEncoder(tnn.TransformerEncoderLayer(
        h, 2, 256, dropout=0.0, activation='gelu', device='cpu'), 1))

    bufs = jfm.extract_buffers(jm)

    def f(params, x):
        loss, _ = jfm.functional_call(
            jm, params, bufs, args=(x,), training=True,
            post_fn=jfm.make_loss_post(
                lambda o, t: paddle.mean(o * t),
                (jax.numpy.asarray(target),)))
        return loss

    jout = jm(paddle.to_tensor(src))
    want_out = np.asarray(jout.numpy())
    want_loss, (want_g, want_gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1)))(jfm.extract_params(jm), jax.numpy.asarray(src))

    before = dict(tfa.counts)
    tm.train()
    x = torch.from_numpy(src).requires_grad_(True)
    out = tm(x)
    loss = torch.mean(out * torch.from_numpy(target))
    loss.backward()
    assert tfa.counts['flash'] == before['flash'] + 1
    assert tfa.counts['bwd_fused'] == before['bwd_fused'] + 1
    assert tfa.counts['bwd_two_pass'] == before['bwd_two_pass']

    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=1e-4)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5,
                               atol=1e-7)
    grads = dict(tm.named_parameters())
    grads = {k: p.grad.numpy() for k, p in grads.items()}
    grads['<input>'] = x.grad.numpy()
    want = {k: np.asarray(v) for k, v in want_g.items()}
    want['<input>'] = np.asarray(want_gx)
    assert set(grads) == set(want)
    for name, w in want.items():
        err = np.abs(grads[name] - w).max()
        assert err <= 1e-4 * max(np.abs(w).max(), 1e-6), (name, err)


@pytest.mark.parametrize('kind', ['bool', 'float'])
def test_masked_encoder_matches_jax_off_flash(kind):
    n, h = 16, 32
    rng = np.random.RandomState(1)
    src = rng.randn(2, n, h).astype(np.float32)
    keep = rng.rand(2, 1, n, n) > 0.3
    keep[..., 0] = True
    mask = keep if kind == 'bool' else \
        np.where(keep, 0.0, -1e9).astype(np.float32)
    paddle.seed(1)
    jm = jnn.TransformerEncoder(jnn.TransformerEncoderLayer(
        h, 4, 64, dropout=0.0, normalize_before=True), 2,
        jnn.LayerNorm(h))
    tm = _carry(jm, tnn.TransformerEncoder(tnn.TransformerEncoderLayer(
        h, 4, 64, dropout=0.0, normalize_before=True, device='cpu'), 2,
        tnn.LayerNorm(h, device='cpu')))
    before = dict(tfa.counts)
    np.testing.assert_allclose(_port_out(tm, src, mask),
                               _jax_out(jm, src, mask), atol=1e-5)
    assert tfa.counts == before


def test_bool_mask_converts_to_the_f32_additive_mask():
    from paddle_tpu_torch.nn.layer.transformer import _convert_attention_mask
    m = torch.tensor([[True, False]])
    out = _convert_attention_mask(m)
    assert out.dtype == torch.float32
    assert out.tolist() == [[0.0, -1e9]]
    f = torch.zeros(2)
    assert _convert_attention_mask(f) is f
    assert _convert_attention_mask(None) is None


def test_mha_cache_step_by_step_equals_the_causal_forward():
    e, n = 32, 6
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(2, n, e).astype(np.float32))
    mha = tnn.MultiHeadAttention(e, 4, device='cpu').eval()
    causal = torch.where(torch.ones(n, n, dtype=torch.bool).tril(), 0.0,
                         -1e9)
    with torch.no_grad():
        full = mha(x, x, x, causal)
        cache = mha.gen_cache(x)
        assert cache.k.shape == (2, 0, 4, 8) and \
            cache.k.dtype == torch.float32
        steps = []
        for i in range(n):
            out, cache = mha(x[:, i:i + 1], x[:, i:i + 1], x[:, i:i + 1],
                             None, cache)
            steps.append(out)
        assert cache.k.shape == (2, n, 4, 8)
        np.testing.assert_allclose(torch.cat(steps, 1).numpy(),
                                   full.numpy(), atol=1e-6)

        memory = torch.from_numpy(rng.randn(2, 9, e).astype(np.float32))
        static = mha.gen_cache(memory, memory, type=mha.StaticCache)
        out, same = mha(x, memory, memory, None, static)
        assert same is static
        np.testing.assert_allclose(out.numpy(),
                                   mha(x, memory, memory).numpy(), atol=1e-6)


def test_mha_caches_match_jax():
    e, n = 32, 5
    rng = np.random.RandomState(3)
    x = rng.randn(2, n, e).astype(np.float32)
    memory = rng.randn(2, 7, e).astype(np.float32)
    paddle.seed(3)
    jm = jnn.MultiHeadAttention(e, 4)
    tm = _carry(jm, tnn.MultiHeadAttention(e, 4, device='cpu'))
    jm.eval()
    tm.eval()
    jc = jm.gen_cache(paddle.to_tensor(x))
    tc = tm.gen_cache(torch.from_numpy(x))
    for i in range(n):
        jo, jc = jm(paddle.to_tensor(x[:, i:i + 1]), cache=jc)
        with torch.no_grad():
            to, tc = tm(torch.from_numpy(x[:, i:i + 1]), cache=tc)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo.numpy()),
                                   atol=1e-5)
    js = jm.gen_cache(paddle.to_tensor(memory), type=jm.StaticCache)
    with torch.no_grad():
        ts = tm.gen_cache(torch.from_numpy(memory), type=tm.StaticCache)
        to, _ = tm(torch.from_numpy(x), cache=ts)
    jo, _ = jm(paddle.to_tensor(x), cache=js)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo.numpy()),
                               atol=1e-5)


def test_transformer_with_its_causal_mask_matches_jax():
    d, src_n, tgt_n = 32, 10, 7
    rng = np.random.RandomState(4)
    src = rng.randn(2, src_n, d).astype(np.float32)
    tgt = rng.randn(2, tgt_n, d).astype(np.float32)
    paddle.seed(4)
    jm = jnn.Transformer(d, 4, 2, 2, 64, dropout=0.0)
    tm = _carry(jm, tnn.Transformer(d, 4, 2, 2, 64, dropout=0.0,
                                    device='cpu'))
    tmask = tm.generate_square_subsequent_mask(tgt_n)
    jmask = np.asarray(jm.generate_square_subsequent_mask(tgt_n).numpy())
    assert tmask.dtype == torch.float32
    np.testing.assert_array_equal(tmask.numpy(), jmask)
    np.testing.assert_allclose(
        _port_out(tm, src, tgt, None, tmask),
        _jax_out(jm, src, tgt, None, paddle.to_tensor(jmask)), atol=2e-5)

    # the decoder's caches step by step against the masked forward
    tm.eval()
    with torch.no_grad():
        memory = tm.encoder(torch.from_numpy(src))
        full = tm.decoder(torch.from_numpy(tgt), memory, tmask)
        cache = tm.decoder.gen_cache(memory)
        steps = []
        for i in range(tgt_n):
            out, cache = tm.decoder(torch.from_numpy(tgt[:, i:i + 1]),
                                    memory, None, None, cache)
            steps.append(out)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                               atol=1e-5)


def _meta(p):
    return (p.param_name, p.trainable, p.optimize_attr, type(p.regularizer),
            getattr(p.regularizer, 'coeff', None), p.need_clip)


@pytest.mark.parametrize('which', ['encoder', 'decoder'])
def test_copied_layers_keep_their_param_attr(which):
    attr = tnn.ParamAttr(learning_rate=0.5,
                         regularizer=treg.L2Decay(1e-3), need_clip=False)
    if which == 'encoder':
        layer = tnn.TransformerEncoderLayer(16, 2, 32, weight_attr=attr,
                                            device='cpu')
        stack = tnn.TransformerEncoder(layer, 3)
    else:
        layer = tnn.TransformerDecoderLayer(16, 2, 32, weight_attr=attr,
                                            device='cpu')
        stack = tnn.TransformerDecoder(layer, 3)
    first = dict(stack.layers[0].named_parameters())
    for i in (1, 2):
        copy = dict(stack.layers[i].named_parameters())
        assert set(copy) == set(first)
        for name, p in copy.items():
            assert _meta(p) == _meta(first[name]), (i, name)
            assert p is not first[name]
            torch.testing.assert_close(p, first[name])
        w = copy['linear1.weight']
        assert w.need_clip is False and w.optimize_attr == {
            'learning_rate': 0.5}
        assert isinstance(w.regularizer, treg.L2Decay)
        assert copy['linear1.bias'].need_clip is True


def test_every_activation_name_builds_a_layer():
    x = torch.randn(2, 4, 8)
    for act in ('relu', 'gelu', 'tanh', 'silu', 'elu'):
        layer = tnn.TransformerEncoderLayer(8, 2, 16, dropout=0.0,
                                            activation=act, device='cpu')
        assert layer(x).shape == x.shape
