"""The port's cost model (paddle_tpu_torch/monitor/perf/costmodel.py) on
the CPU: its FLOPs equal a hand count exactly for a matmul and for a
2-layer GPT's TrainStep below the flash gate (fused and unfused loss);
the flash ops' formulas equal the pair counts chip_smoke's kernel
bounds use, on every route; a custom op of the port without a formula
raises; pricing leaves the step's parameters and slots as they were;
Model.summary_perf returns the JAX package's keys; the JAX cost model
counts at least the port's FLOPs on the same model (XLA also counts the
elementwise work, on purpose: see ROADMAP's expected divergences).
"""
import math

import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu as paddle
import paddle_tpu_torch as tpt
from paddle_tpu.text.models import gpt as jgpt
from paddle_tpu_torch.framework.functional import TrainStep
from paddle_tpu_torch.monitor.perf import costmodel
from paddle_tpu_torch.monitor.registry import MetricRegistry
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.text.models import gpt as tgpt

CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=2,
           max_position_embeddings=64, dropout=0.0)
BATCH, SEQ = 2, 16


def test_matmul_flops_and_bytes_exact():
    a, b = torch.randn(8, 16), torch.randn(16, 32)
    out = costmodel.count(torch.matmul, a, b)
    assert out == {'flops': 2.0 * 8 * 16 * 32,
                   'bytes_accessed': 4.0 * (8 * 16 + 16 * 32 + 8 * 32)}


def _gpt_step(fused):
    model = tgpt.GPTForCausalLM(tgpt.GPTConfig(fused_loss=fused, **CFG),
                                device='cpu', seed=0)
    step = TrainStep(model, model.loss,
                     AdamW(learning_rate=1e-3, parameters=model.parameters()))
    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(0, CFG['vocab_size'], (BATCH, SEQ), generator=gen)
    labels = torch.randint(0, CFG['vocab_size'], (BATCH, SEQ), generator=gen)
    return model, step, ids, labels


@pytest.mark.parametrize('fused', [False, True])
def test_gpt_train_step_flops_hand_count(fused):
    """Forward + backward of every GEMM (6 flops a multiply-add of the
    four per layer: 12 h^2 a token), the attention's two score products
    forward and five backward over all n^2 pairs (torch's SDPA formulas,
    below the flash gate), the LM head (3 GEMMs unfused; the fused loss
    ops 1 + 3); the optimizer's elementwise update counts 0."""
    model, step, ids, labels = _gpt_step(fused)
    h, layers, vocab = CFG['hidden_size'], CFG['num_layers'], \
        CFG['vocab_size']
    heads, d, tokens = CFG['num_heads'], h // CFG['num_heads'], BATCH * SEQ
    want = (layers * 6 * tokens * 12 * h * h +
            (8 if fused else 6) * tokens * h * vocab +
            layers * (2 + 5) * 2 * BATCH * heads * SEQ * SEQ * d)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    cost = costmodel.cost_of(step, (ids,), (labels,))
    assert cost['flops'] == want
    assert cost['bytes_accessed'] > 0
    assert all(torch.equal(v, model.state_dict()[k])
               for k, v in before.items())
    assert step.optimizer._slots == {} and step.optimizer._step_count == 0
    assert fa.counts['flash'] >= 0          # no kernel ran for the count


def _pairs_brute(n, m, causal):
    return sum(min(i + 1, m) for i in range(n)) if causal else n * m


def _ops_sku():
    """A datasheet row with unbounded memory: every chip_smoke bound is
    its operations count over the row's rate."""
    return ('probe', 1e300, {'float32': 1e12, 'bfloat16': 1e12,
                             'float16': 1e12, 'float32_cuda_cores': 1e12})


@pytest.mark.parametrize('n,m,causal', [(512, 512, True), (33, 33, True),
                                        (512, 1024, False),
                                        (1024, 1024, True)])
def test_flash_formulas_equal_kernel_bound_counts(n, m, causal):
    """The flash ops counted on fake tensors equal chip_smoke's kernel
    bound counts (2 products forward; backward 5 fused at max(n, m) <=
    512, else 3 + 4) and the pairs counted one by one."""
    b, h, d = 2, 3, 64
    q = torch.randn(b, h, n, d)
    k, v = torch.randn(b, h, m, d), torch.randn(b, h, m, d)
    scale = 1.0 / math.sqrt(d)
    sku = _ops_sku()
    fwd = costmodel.count(
        lambda q, k, v: fa.flash_fwd_op(q, k, v, causal, scale), q, k, v)
    pairs = _pairs_brute(n, m, causal)
    assert costmodel.flash_pairs(n, m, causal) == pairs
    assert fwd['flops'] == 4 * d * b * h * pairs
    ms, by = chip_smoke._flash_bound_ms(b, h, n, m, d, torch.float32,
                                        causal, sku)
    assert by == 'operations' and ms * 1e9 == pytest.approx(fwd['flops'],
                                                            rel=1e-12)
    o, lse = torch.randn(b, h, n, d), torch.randn(b, h, n, 1)
    bwd = costmodel.count(
        lambda *a: fa.flash_bwd_op(*a, causal, scale), q, k, v, o, lse,
        torch.randn(b, h, n, d))
    whichs = ('fused',) if max(n, m) <= fa.FUSED_BWD_MAX_SEQ else \
        ('dq', 'dkv')
    bound = sum(chip_smoke._bwd_bound_ms(b, h, n, m, d, torch.float32,
                                         causal, w, sku)[0] for w in whichs)
    assert bwd['flops'] == sum(costmodel.BWD_PRODUCTS[w] for w in whichs) \
        * 2 * d * b * h * pairs
    assert bound * 1e9 == pytest.approx(bwd['flops'], rel=1e-12)


def test_custom_op_without_formula_raises():
    """A port op the cost model has no formula for is refused, never
    counted as 0 flops."""
    @torch.library.custom_op('paddle_tpu_torch::costmodel_probe',
                             mutates_args=())
    def probe(x: torch.Tensor) -> torch.Tensor:
        return x.clone()

    @probe.register_fake
    def _(x):
        return torch.empty_like(x)

    with pytest.raises(RuntimeError, match='no flop formula'):
        costmodel.count(probe, torch.randn(4))


def test_peaks_and_roofline():
    assert costmodel.sku('NVIDIA H100 80GB HBM3')[0] == 'H100'
    assert costmodel.sku('NVIDIA H100 PCIe')[0] == 'H100 PCIe'
    with pytest.raises(RuntimeError):
        costmodel.sku('Some Other Card')
    plat, pf, pb = costmodel.platform_peaks('H100')
    assert (plat, pf, pb) == ('H100', 989e12, 3.35e12)
    assert costmodel.platform_peaks('H100', dtype='float32')[1] == 495e12 / 3
    r = costmodel.roofline(989e12, 1e9, platform='H100')
    assert r['roofline_bound'] == 'compute' and r['ideal_step_s'] == 1.0
    est = costmodel.estimate({'flops': 2e12, 'bytes_accessed': 1e12},
                             step_seconds=1.0, platform='H100')
    assert est['mfu_est'] == 2e12 / 989e12
    assert est['roofline_frac'] == est['ideal_step_s'] == 1e12 / 3.35e12
    reg = MetricRegistry()
    costmodel.record(est, registry=reg)
    assert reg.get('perf_mfu_est').value() == est['mfu_est']
    assert reg.get('perf_roofline_bound').value() == 0.0


def test_summary_perf_keys_and_jax_counts_at_least_ports():
    """Model.summary_perf on the same GPT and batch in both packages: the
    port's dict has the JAX dict's keys, and XLA's FLOPs (which include
    the elementwise work) are at least the port's matmul count."""
    paddle.seed(3)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**CFG))
    jmodel = paddle.Model(jm)
    jmodel.prepare(optimizer=paddle.optimizer.AdamW(
        learning_rate=1e-3, parameters=jm.parameters()), loss=jm.loss)
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**CFG), device='cpu', seed=0)
    tgpt.load_paddle_tpu_state(tm, {k: np.asarray(v.numpy())
                                    for k, v in jm.state_dict().items()})
    tmodel = tpt.Model(tm)
    tmodel.prepare(optimizer=tpt.optimizer.AdamW(
        learning_rate=1e-3, parameters=tm.parameters()), loss=tm.loss)
    ids = np.random.RandomState(0).randint(0, CFG['vocab_size'],
                                           (BATCH, SEQ + 1))
    jest = jmodel.summary_perf([paddle.to_tensor(ids[:, :-1])],
                               [paddle.to_tensor(ids[:, 1:])],
                               step_seconds=0.01)
    test = tmodel.summary_perf(torch.from_numpy(ids[:, :-1]),
                               torch.from_numpy(ids[:, 1:]),
                               step_seconds=0.01)
    assert set(test) == set(jest)
    assert jest['flops'] >= test['flops'] > 0


@pytest.mark.parametrize('dtype,key', [(torch.float32, 'float32'),
                                       (torch.bfloat16, 'bfloat16')])
def test_summary_perf_prices_against_the_steps_dtype(monkeypatch, dtype,
                                                     key):
    """summary_perf takes the peak for the step's compute dtype (here its
    parameters'): an f32 step on an H100 gets the f32 row's rate, not the
    bf16 one."""
    net = torch.nn.Linear(16, 8).to(dtype)
    model = tpt.Model(net)
    model.prepare(optimizer=tpt.optimizer.SGD(
        learning_rate=0.1, parameters=net.parameters()),
        loss=torch.nn.functional.mse_loss)
    x, y = torch.randn(4, 16, dtype=dtype), torch.randn(4, 8, dtype=dtype)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'get_device_name',
                        lambda *a: 'NVIDIA H100 80GB HBM3')
    est = model.summary_perf(x, y, step_seconds=1e-3)
    _, _, ops = costmodel.sku('NVIDIA H100 80GB HBM3')
    assert est['platform'] == 'H100' and est['peak_flops'] == ops[key]
    assert est['mfu_est'] == est['flops'] / 1e-3 / ops[key]
