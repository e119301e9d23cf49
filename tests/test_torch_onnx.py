"""The port's ONNX exporter (paddle_tpu_torch/onnx.py) against the JAX
package's (paddle_tpu/onnx.py).

Each model is built in JAX, carried to the port, and exported by both
packages at one static input spec. Both graphs are read back and run by
the numpy evaluator (tests/onnx_numpy.py, tests/test_onnx.py's with Conv
and the pools added), and held to each other and to both eager forwards:
2e-5 for the MLP and LeNet, 2e-4 for the GPTs, as tests/test_onnx.py
holds them.

- The MLP of tests/test_onnx.py (Linear, Tanh, LayerNorm, Linear).
- Its tiny GPT (vocab 64, 32 wide, 2 layers of 2 heads, n = 16): masked
  attention in both packages.
- A GPT at n = 512 with head_dim 64 (vocab 64, 128 wide, 2 layers of 2
  heads; the tiny GPT's head_dim 16 has no flash kernel): the port's
  attention takes the flash custom op, which the exporter lowers to the
  ops of its plain version; the JAX package on the CPU, without
  PADDLE_TPU_FLASH_INTERPRET, takes its plain route.
- The vision LeNet (Conv, MaxPool).

The port's GPT graphs also run under tests/test_onnx.py's own evaluator.
The protobuf writer's bytes equal the JAX package's for the same inputs,
and both packages refuse sort, a dynamic dim and bfloat16 alike.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import onnx as jonnx
from paddle_tpu.static.input_spec import InputSpec as JSpec
from paddle_tpu.text.models.gpt import GPTConfig as JConfig
from paddle_tpu.text.models.gpt import GPTForCausalLM as JGPT
import paddle_tpu_torch as tpt
from paddle_tpu_torch import onnx as tonnx
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.static import InputSpec as TSpec
from paddle_tpu_torch.text.models import gpt as tgpt
from paddle_tpu_torch.vision.models import load_vision_state

import onnx_numpy
import test_onnx
from jax_numpy_init import install

TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
            max_position_embeddings=16, dropout=0.0)
WIDE = dict(TINY, hidden_size=128, max_position_embeddings=512)


def _state(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _mlp():
    paddle.seed(7)
    jm = paddle.nn.Sequential(paddle.nn.Linear(16, 32), paddle.nn.Tanh(),
                              paddle.nn.LayerNorm(32),
                              paddle.nn.Linear(32, 8))
    tm = tpt.nn.Sequential(tpt.nn.Linear(16, 32, device='cpu'),
                           tpt.nn.Tanh(),
                           tpt.nn.LayerNorm(32, device='cpu'),
                           tpt.nn.Linear(32, 8, device='cpu'))
    tm.load_state_dict({k: torch.from_numpy(v)
                        for k, v in _state(jm).items()})
    x = np.random.RandomState(0).randn(4, 16).astype(np.float32)
    return jm, tm, ([4, 16], 'float32', 'x'), x


def _gpt(cfg, n, seed):
    def build():
        paddle.seed(seed)
        jm = JGPT(JConfig(**cfg))
        tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**cfg), device='cpu')
        tgpt.load_paddle_tpu_state(tm, _state(jm))
        ids = np.random.RandomState(1).randint(
            0, cfg['vocab_size'], (2 if n == 16 else 1, n)).astype(np.int32)
        return jm, tm, (list(ids.shape), 'int32', 'ids'), ids
    return build


def _lenet():
    from paddle_tpu.vision.models import LeNet as JLeNet
    from paddle_tpu_torch.vision.models import LeNet as TLeNet
    jm = JLeNet()
    tm = TLeNet(device='cpu')
    load_vision_state(tm, _state(jm))
    x = np.random.RandomState(2).randn(2, 1, 28, 28).astype(np.float32)
    return jm, tm, ([2, 1, 28, 28], 'float32', 'img'), x


CASES = {'mlp': (_mlp, 2e-5), 'gpt_n16': (_gpt(TINY, 16, 3), 2e-4),
         'gpt_n512': (_gpt(WIDE, 512, 4), 2e-4), 'lenet': (_lenet, 2e-5)}


@pytest.fixture(scope='module')
def exported(tmp_path_factory):
    """Every case built, run eagerly and exported by both packages, once
    a module. The JAX layers draw their weights with numpy
    (jax_numpy_init); the JAX attention takes its plain route."""
    mp = pytest.MonkeyPatch()
    install(mp)
    mp.delenv('PADDLE_TPU_FLASH_INTERPRET', raising=False)
    root = tmp_path_factory.mktemp('onnx')
    out = {}
    try:
        for name, (build, _) in CASES.items():
            jm, tm, (shape, dtype, in_name), x = build()
            jm.eval()
            tm.eval()
            before = tfa.counts['flash']
            with torch.no_grad():
                t_eager = tm(torch.from_numpy(x)).numpy()
            flash_eager = tfa.counts['flash'] - before
            j_eager = np.asarray(jm(paddle.to_tensor(x)).numpy())
            jpath = jonnx.export(jm, str(root / ('jax_' + name)),
                                 input_spec=[JSpec(shape, dtype, in_name)])
            tpath = tonnx.export(tm, str(root / ('torch_' + name)),
                                 input_spec=[TSpec(shape, dtype, in_name)])
            out[name] = dict(
                x=x, in_name=in_name, t_eager=t_eager, j_eager=j_eager,
                flash_eager=flash_eager, stats=dict(tonnx.export.stats),
                jblob=open(jpath, 'rb').read(),
                tblob=open(tpath, 'rb').read())
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize('case', list(CASES))
def test_graphs_match_each_other_and_eager(exported, case):
    e = exported[case]
    tol = CASES[case][1]
    feeds = {e['in_name']: e['x']}
    t_got = onnx_numpy.run_onnx(e['tblob'], feeds)
    j_got = onnx_numpy.run_onnx(e['jblob'], feeds)
    assert len(t_got) == len(j_got) == 1
    assert t_got[0].shape == j_got[0].shape == e['t_eager'].shape
    assert t_got[0].dtype == np.float32
    for got in (t_got[0], j_got[0]):
        for want in (e['t_eager'], e['j_eager']):
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize('case', ['gpt_n16', 'gpt_n512'])
def test_port_gpt_graph_runs_under_test_onnx_evaluator(exported, case):
    e = exported[case]
    got = test_onnx._run_onnx(e['tblob'], {e['in_name']: e['x']})
    np.testing.assert_allclose(got[0], e['t_eager'], rtol=2e-4, atol=2e-4)


def test_flash_op_lowered_to_its_plain_version(exported):
    """At n = 512 the port's eager forward launches the flash op a layer
    and the graph holds its lowering a layer: the causal mask a constant,
    the softmax's max with opset 13's axes attribute, no custom op."""
    e = exported['gpt_n512']
    assert e['flash_eager'] == WIDE['num_layers']
    assert e['stats']['flash_lowered'] == WIDE['num_layers']
    assert exported['gpt_n16']['stats']['flash_lowered'] == 0
    nodes, inits, _, _ = onnx_numpy.parse_model(e['tblob'])
    ops = {op for op, _, _, _ in nodes}
    assert not any('flash' in op for op in ops)
    masks = [a for a in inits.values()
             if a.dtype == np.bool_ and a.shape == (512, 512)]
    assert masks and all(np.array_equal(m, np.tril(np.ones((512, 512),
                                                           bool)))
                         for m in masks)
    for op, ins, _, attrs in nodes:
        if op == 'ReduceMax':
            assert attrs['axes'] and len(ins) == 1
        if op == 'ReduceSum':
            assert len(ins) == 2 and 'axes' not in attrs


def _jax_writer_inputs():
    arrays = [np.arange(6, dtype=np.float32).reshape(2, 3),
              np.float32(1.5), np.array([True, False]),
              np.arange(4, dtype=np.int64) - 2,
              np.arange(3, dtype=np.int32), np.ones((1, 2), np.float16),
              np.arange(2, dtype=np.float64), np.arange(3, dtype=np.uint8),
              np.arange(3, dtype=np.int8)]
    return arrays


@pytest.mark.parametrize('idx', range(len(_jax_writer_inputs())))
def test_writer_bytes_equal_jax(idx):
    arr = _jax_writer_inputs()[idx]
    assert tonnx._tensor_proto('w_%d' % idx, arr) == \
        jonnx._tensor_proto('w_%d' % idx, arr)
    shape = np.shape(arr)
    assert tonnx._value_info('v', shape, arr.dtype) == \
        jonnx._value_info('v', shape, arr.dtype)


def test_writer_nodes_and_model_bytes_equal_jax():
    attrs = {'perm': [0, 2, 1], 'axis': -1, 'alpha': 0.5, 'mode': 'same',
             'keepdims': True, 'pads': [0, -1, 2]}
    t = tonnx._node('Op', ['a', 'b'], ['c'], attrs, name='Op_1')
    assert t == jonnx._node('Op', ['a', 'b'], ['c'], attrs, name='Op_1')
    assert tonnx._node('Id', ['a'], ['b']) == jonnx._node('Id', ['a'], ['b'])
    for opset in (13, 18):
        assert tonnx._model_proto(t, opset) == jonnx._model_proto(t, opset)
    for bad in ([1.0, 2.0], None):
        with pytest.raises(NotImplementedError):
            tonnx._attr('x', bad)
        with pytest.raises(NotImplementedError):
            jonnx._attr('x', bad)


def test_opset_18_takes_reduce_axes_as_inputs(tmp_path):
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**TINY), device='cpu', seed=1)
    tm.eval()
    path = tonnx.export(tm, str(tmp_path / 'g18.onnx'), opset_version=18,
                        input_spec=[TSpec([1, 16], 'int32', 'ids')])
    nodes, _, g_in, g_out = onnx_numpy.parse_model(open(path, 'rb').read())
    reduce_max = [(ins, attrs) for op, ins, _, attrs in nodes
                  if op == 'ReduceMax']
    assert reduce_max and all(len(ins) == 2 and 'axes' not in attrs
                              for ins, attrs in reduce_max)
    assert g_in == ['ids'] and g_out == ['output_0']
    ids = np.random.RandomState(5).randint(0, 64, (1, 16)).astype(np.int32)
    with torch.no_grad():
        want = tm(torch.from_numpy(ids)).numpy()
    got = onnx_numpy.run_onnx(open(path, 'rb').read(), {'ids': ids})[0]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


class _JSorter(paddle.nn.Layer):
    def forward(self, x):
        from paddle_tpu.tensor import search
        return search.sort(x)


class _TSorter(torch.nn.Module):
    def forward(self, x):
        return tpt.tensor.search.sort(x)


def test_sort_refused_by_both(tmp_path, monkeypatch):
    # a model without weights traces on the current device: the card by
    # default, which this host lacks
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        tonnx.export(_TSorter(), str(tmp_path / 't'),
                     input_spec=[TSpec([4, 4], 'float32', 'x')])
    from paddle_tpu_torch.framework import device as device_mod
    monkeypatch.setitem(device_mod._STATE, 'device', 'cpu')
    with pytest.raises(NotImplementedError, match='not supported') as te:
        tonnx.export(_TSorter(), str(tmp_path / 't'),
                     input_spec=[TSpec([4, 4], 'float32', 'x')])
    assert 'sort' in str(te.value) and 'aten.mm' in str(te.value)
    with pytest.raises(NotImplementedError, match='not supported') as je:
        jonnx.export(_JSorter(), str(tmp_path / 'j'),
                     input_spec=[JSpec([4, 4], 'float32', 'x')])
    assert 'sort' in str(je.value)


def test_dynamic_dim_refused_by_both(tmp_path):
    jm, tm, _, _ = _mlp()
    for mod, model, spec in ((tonnx, tm, TSpec), (jonnx, jm, JSpec)):
        with pytest.raises(ValueError, match='fully static'):
            mod.export(model, str(tmp_path / 'm'),
                       input_spec=[spec([None, 16], 'float32', 'x')])
        with pytest.raises(ValueError, match='requires input_spec'):
            mod.export(model, str(tmp_path / 'm'))


def test_bfloat16_refused_by_both(tmp_path):
    jm, tm, _, _ = _mlp()
    for mod, model, spec in ((tonnx, tm, TSpec), (jonnx, jm, JSpec)):
        with pytest.raises(NotImplementedError,
                           match='unsupported dtype bfloat16'):
            mod.export(model, str(tmp_path / 'm'),
                       input_spec=[spec([4, 16], 'bfloat16', 'x')])
    # a bf16 model with an f32 input: its weights cannot be carried
    tm.to(torch.bfloat16)
    with pytest.raises(NotImplementedError,
                       match='unsupported dtype bfloat16'):
        tonnx.export(tm, str(tmp_path / 'm'),
                     input_spec=[TSpec([4, 16], 'float32', 'x')])


def test_top_level_export_and_stats(tmp_path):
    assert tpt.onnx is tonnx
    _, tm, (shape, dtype, name), x = _mlp()
    tm.eval()
    path = tpt.onnx.export(tm, str(tmp_path / 'mlp.onnx'),
                           input_spec=[torch.from_numpy(x)])
    assert path.endswith('mlp.onnx')
    blob = open(path, 'rb').read()
    stats = tonnx.export.stats
    assert stats['bytes'] == len(blob) and stats['flash_lowered'] == 0
    nodes, inits, g_in, _ = onnx_numpy.parse_model(blob)
    assert g_in == ['input_0'] and stats['nodes'] == len(nodes)
    assert stats['initializers'] == len(inits)
    # the weights are initializers; nothing unread is written
    read = {i for _, ins, _, _ in nodes for i in ins}
    assert set(inits) <= read
    got = onnx_numpy.run_onnx(blob, {'input_0': x})[0]
    with torch.no_grad():
        np.testing.assert_allclose(got, tm(torch.from_numpy(x)).numpy(),
                                   rtol=2e-5, atol=2e-5)


# -- the converter's handlers beyond the four models, each case's graph
# run by the evaluator against the eager forward (2e-5)

class _OnCPU(torch.nn.Module):
    """A weightless layer traces on the current device (the card by
    default): a buffer puts it on the CPU."""

    def __init__(self):
        super().__init__()
        self.register_buffer('one', torch.ones(()))


class _Elementwise(_OnCPU):
    def forward(self, x):
        y = torch.nn.functional.silu(x) * self.one + torch.relu(-x) * 0.5
        y = torch.clamp(y, -0.7, 2.0) + torch.clamp(x, min=0.1)
        y = y + 1.0 - x / 3.0 + torch.floor_divide(x * 4.0, 3.0)
        y = y + torch.rsqrt(x * x + 1.0) + torch.reciprocal(x.abs() + 1.0)
        y = y + torch.where(x > 0.2, x, 0.0) + torch.pow(x, 3) + x ** 2
        y = y + (x != 0.1).float() + ((x > 0) & (x < 1)).float()
        y = y + torch.nn.functional.gelu(x, approximate='tanh')
        return y + torch.exp(-x.abs()) + torch.sigmoid(x) * torch.tanh(x)


class _Reductions(_OnCPU):
    def forward(self, x):
        x = x * self.one
        m, i = x.max(dim=1, keepdim=True)
        y = torch.log_softmax(x, dim=-1) + m + i.float()
        y = y + x.mean(dim=(0, 1), keepdim=True) + x.sum(-1, keepdim=True)
        y = y + x.amin(dim=0) + torch.argmax(x, dim=-1, keepdim=True)
        return y + torch.softmax(x, dim=0)


class _Shapes(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.linspace(-1, 1, 30).reshape(6, 5))
        self.b = torch.nn.Parameter(torch.linspace(0, 1, 5))

    def forward(self, x):
        a, b, c = torch.split(x, [2, 3, 1], dim=1)
        y = torch.cat([c, b, a], dim=1)
        y = torch.addmm(self.b, y, self.w)
        z = y.reshape(2, 2, 5).transpose(1, 2)[:, 1:4, ::2]
        z = z.unsqueeze(0).squeeze(0) + x[:, 0].reshape(2, 2, 1)[:, :1, :]
        return z.flatten(1) @ torch.ones(3, 2) + x.chunk(2, dim=1)[1].sum()


class _Vision(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = tpt.nn.Conv2D(3, 4, 3, padding=1, groups=1, device='cpu')
        self.dw = tpt.nn.Conv2D(4, 4, 3, stride=2, padding=1, groups=4,
                                device='cpu')
        self.bn = tpt.nn.BatchNorm2D(4, device='cpu')
        self.emb = tpt.nn.Embedding(10, 4, device='cpu')

    def forward(self, x):
        y = self.bn(self.dw(torch.relu(self.conv(x))))
        y = torch.nn.functional.avg_pool2d(y, 2, 2) + \
            torch.nn.functional.max_pool2d(y, 3, 1, 1)[:, :, ::2, ::2]
        y = torch.nn.functional.adaptive_avg_pool2d(y, 1).flatten(1)
        ids = (x[:, 0, 0, :4].abs() * 9).long().clamp(0, 9)
        return y + self.emb(ids).sum(1)


class _Core(_OnCPU):
    """Core ATen ops the other cases do not reach."""

    def __init__(self):
        super().__init__()
        self.register_buffer('mean', torch.linspace(-0.2, 0.2, 3))
        self.register_buffer('var', torch.linspace(0.5, 1.5, 3))

    def forward(self, x):
        y = torch.nn.functional.batch_norm(x, self.mean, self.var,
                                           training=False, eps=1e-3)
        y = y + torch.sqrt(x.abs()) + torch.log(x.abs() + 1) + torch.erf(x)
        y = y + torch.floor(x) + torch.ceil(x) + torch.sign(x)
        y = y + torch.maximum(x, y) + torch.minimum(x, 0.5 * y)
        y = y + x.amax(dim=-1, keepdim=True)
        y = y + ((x == 0.5) | (x >= 1.0) | ~(x < -1.0)).float()
        return y * self.one


OP_CASES = {'elementwise': (_Elementwise, [3, 7]),
            'core': (_Core, [2, 3, 5]),
            'reductions': (_Reductions, [4, 6]),
            'shapes': (_Shapes, [4, 6]),
            'vision': (_Vision, [2, 3, 8, 8])}


@pytest.mark.parametrize('case', sorted(OP_CASES))
def test_op_handlers_match_eager(case, tmp_path):
    cls, shape = OP_CASES[case]
    torch.manual_seed(0)
    model = cls().eval()
    for m in model.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.running_mean.uniform_(-0.5, 0.5)
            m.running_var.uniform_(0.5, 2.0)
    x = np.random.RandomState(3).uniform(-1.5, 1.5, shape).astype(
        np.float32)
    with torch.no_grad():
        want = model(torch.from_numpy(x)).numpy()
    path = tonnx.export(model, str(tmp_path / case),
                        input_spec=[TSpec(shape, 'float32', 'x')])
    got = onnx_numpy.run_onnx(open(path, 'rb').read(), {'x': x})[0]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
