"""The port's weight-only int8 quantization (paddle_tpu_torch/slim/
weight_only.py) against the JAX package's, on the CPU: the int8 weights
and per-channel scales bit for bit (f32 and bf16 sources), the forward
within 1e-6, the swap's structure (exclusion, sharing, the bare root),
streamed_bytes equal to the JAX count, and a 2-layer GPT carried across
from the JAX package and quantized in both: generate() token-identical in
f32, the slot engine identical to generate(), a JAX-quantized state dict
loaded through load_paddle_tpu_state.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.slim import weight_only as jwo
from paddle_tpu.text.models.gpt import GPTConfig as JConfig
from paddle_tpu.text.models.gpt import GPTForCausalLM as JGPT

import paddle_tpu_torch as tpt
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.serving import ContinuousBatchingEngine
from paddle_tpu_torch.slim import WeightOnlyLinear, quantize_weight_only
from paddle_tpu_torch.slim import weight_only as two
from paddle_tpu_torch.text.models import gpt as tgpt

from jax_numpy_init import numpy_init  # noqa: F401

CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
           max_position_embeddings=64, dropout=0.0)


def _state(jl):
    return {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_int8_weights_and_scales_bit_for_bit(dtype):
    rng = np.random.RandomState(0)
    w = (rng.standard_normal((64, 48)) *
         np.linspace(0.01, 3, 48)).astype(np.float32)
    w[:, 5] = 0.0   # an all-zero channel takes the 1e-8 floor
    jq, js = jwo._quantize_int8(jnp.asarray(w, getattr(jnp, dtype)))
    tq, ts = two._quantize_int8(torch.tensor(w).to(getattr(torch, dtype)))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[5].item() == np.float32(1e-8)


def test_weight_only_linear_matches_jax(numpy_init):
    jl = jnn.Linear(64, 48)
    tl = tnn.Linear(64, 48, device='cpu')
    tgpt.load_paddle_tpu_state(tl, _state(jl))
    jq, tq = jwo.WeightOnlyLinear(jl), WeightOnlyLinear(tl)
    jq.eval()
    tq.eval()
    x = np.random.RandomState(1).standard_normal((16, 64)).astype(
        np.float32)
    got = tq(torch.from_numpy(x)).detach().numpy()
    want = jq(paddle.to_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert tq.qweight.dtype == torch.int8 and tuple(tq.qweight.shape) == \
        (64, 48)
    assert tuple(tq.weight_scale.shape) == (48,)
    assert not hasattr(tq, 'weight')
    assert sorted(dict(tq.named_buffers())) == sorted(
        k for k, _ in jq.named_buffers())
    # numerics stay close to the float layer
    ref = tl(torch.from_numpy(x)).detach().numpy()
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 0.02


def test_weight_only_linear_refuses_training():
    q = WeightOnlyLinear(tnn.Linear(8, 8, device='cpu'))
    q.train()
    with pytest.raises(RuntimeError, match='inference-only'):
        q(torch.zeros(2, 8))


def test_swaps_excludes_and_counts_as_jax(numpy_init):
    def build(mod, **kw):
        return mod.Sequential(mod.Linear(8, 16, **kw), mod.ReLU(),
                              mod.Sequential(mod.Linear(16, 16, **kw)),
                              mod.Linear(16, 4, **kw))
    jm, tm = build(jnn), build(tnn, device='cpu')
    jn = jwo.quantize_weight_only(
        jm, exclude=lambda name, layer: layer._out_features == 4)
    tn = quantize_weight_only(
        tm, exclude=lambda name, layer: layer.out_features == 4)
    assert tn == jn == 2
    assert isinstance(tm[0], WeightOnlyLinear)
    assert isinstance(tm[2][0], WeightOnlyLinear)
    assert type(tm[3]) is tnn.Linear
    names, jnames = [], []
    quantize_weight_only(build(tnn, device='cpu'),
                         exclude=lambda name, layer: names.append(name))
    jwo.quantize_weight_only(build(jnn),
                             exclude=lambda name, l: jnames.append(name))
    assert names == jnames == ['0', '3', '2.0']


class _TwoPath(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.proj = tnn.Linear(8, 8, device='cpu')
        self.head = self.proj

    def forward(self, x):
        return self.proj(x) + self.head(x)


def test_sharing_kept_and_any_alias_excluded():
    model = _TwoPath()
    assert quantize_weight_only(model) == 1
    assert model.proj is model.head
    assert isinstance(model.proj, WeightOnlyLinear)
    model = _TwoPath()
    assert quantize_weight_only(
        model, exclude=lambda name, layer: name.endswith('head')) == 0
    assert model.proj is model.head and type(model.proj) is tnn.Linear


def test_bare_root_linear():
    lin = tnn.Linear(8, 8, device='cpu')
    with pytest.raises(ValueError, match='WeightOnlyLinear'):
        quantize_weight_only(lin)
    assert type(lin) is tnn.Linear
    assert quantize_weight_only(lin, exclude=lambda name, layer: True) == 0


@pytest.fixture(scope='module')
def gpt_pair():
    paddle.seed(21)
    jm = JGPT(JConfig(**CFG))
    jm.eval()
    state = _state(jm)
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**CFG), device='cpu', seed=3)
    tgpt.load_paddle_tpu_state(tm, state)
    tm.eval()
    return jm, tm, state


def _prompts(seed=0, b=2, n=8):
    return np.random.RandomState(seed).randint(0, CFG['vocab_size'],
                                               (b, n)).astype(np.int32)


def test_gpt_quantized_in_both_packages(gpt_pair):
    jm, tm, _ = gpt_pair
    jbytes, tbytes = jwo.streamed_bytes(jm), two.streamed_bytes(tm)
    assert tbytes == jbytes
    assert jwo.quantize_weight_only(jm) == quantize_weight_only(tm) == \
        2 * 4   # qkv_proj, out_proj, fc_in, fc_out per block
    assert two.streamed_bytes(tm) == jwo.streamed_bytes(jm) < tbytes
    # the tied head stays the embedding
    assert tm.lm_head is None
    assert tgpt.cache_heads(tm) == CFG['num_heads']
    jstate = _state(jm)
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), jstate[k], err_msg=k)
    ids = _prompts()
    got = tm.generate(torch.from_numpy(ids).long(),
                      max_new_tokens=12).numpy()
    want = np.asarray(jm.generate(paddle.to_tensor(ids),
                                  max_new_tokens=12).numpy())
    np.testing.assert_array_equal(got, want)
    with torch.no_grad():
        logits = tm(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(logits, jm(paddle.to_tensor(ids)).numpy(),
                               rtol=1e-5, atol=1e-5)
    # the slot engine over the quantized model: generate()'s tails
    prompts = [list(map(int, ids[0])), list(map(int, ids[1][:5]))]
    eng = ContinuousBatchingEngine(tm, num_slots=2, max_len=48,
                                   prefill_chunk=8, decode_block=4)
    out = eng.generate(prompts, max_new_tokens=10)
    for p, toks in zip(prompts, out):
        ref = tm.generate(torch.tensor([p]), max_new_tokens=10)[0, len(p):]
        assert toks == ref.tolist()


def test_jax_quantized_state_loads_into_the_port(gpt_pair, tmp_path):
    _, _, state = gpt_pair
    paddle.seed(0)
    jm = JGPT(JConfig(**CFG))
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    jm.eval()
    jwo.quantize_weight_only(jm)
    jq = _state(jm)
    assert jq['gpt.h.0.attn.qkv_proj.qweight'].dtype == np.int8
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**CFG), device='cpu', seed=9)
    tm.eval()
    quantize_weight_only(tm)
    tgpt.load_paddle_tpu_state(tm, jq)
    ids = _prompts(seed=4)
    with torch.no_grad():
        logits = tm(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(logits, jm(paddle.to_tensor(ids)).numpy(),
                               rtol=1e-5, atol=1e-5)
    # the port's own state-dict round trip
    path = str(tmp_path / 'wq.pdparams')
    tpt.save(tm.state_dict(), path)
    other = tgpt.GPTForCausalLM(tgpt.GPTConfig(**CFG), device='cpu', seed=2)
    other.eval()
    quantize_weight_only(other)
    other.load_state_dict(tpt.load(path))
    with torch.no_grad():
        np.testing.assert_array_equal(
            other(torch.from_numpy(ids).long()).numpy(), logits)
    assert other.gpt.h[0].attn.qkv_proj.qweight.dtype == torch.int8
