"""The port's jit.save / jit.load against the JAX package's.

A 2-layer, hidden-64 GPT (one head of 64) carried across from the JAX
package with load_paddle_tpu_state, saved with InputSpec([2, 512],
'int64'): the eval forward is exported by torch.export through the flash
custom op (seq 512 takes the flash route). Loaded on the CPU its outputs
equal the saved model's bit for bit and the JAX model's within 1e-4, the
exported program runs to the same logits, and a fresh process that has
imported only paddle_tpu_torch loads it. The artifact's version gates are
tests/test_inference.py::test_jit_artifact_version_gate's and
tests/test_op_version.py's, and an MLP round trip is held against the
JAX package's own jit.save / jit.load on the same weights.
"""
import os
import pickle
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as tpt
from paddle_tpu.text.models.gpt import GPTConfig as JConfig
from paddle_tpu.text.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch.framework import op_version as opv
from paddle_tpu_torch.static import InputSpec
from paddle_tpu_torch.text.models import gpt as tgpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=1,
           max_position_embeddings=512, dropout=0.0)


@pytest.fixture(scope='module')
def saved(tmp_path_factory):
    """The JAX GPT's logits on a seeded batch, and the port's GPT on the
    same weights, saved with an input spec."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('PADDLE_TPU_FLASH_INTERPRET', '1')
        mp.setenv('PADDLE_TPU_FLASH_STRICT', '1')
        paddle.seed(31)
        jm = JGPT(JConfig(**CFG))
        jm.eval()
        tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**CFG), device='cpu')
        tgpt.load_paddle_tpu_state(tm, {k: np.asarray(v.numpy())
                                        for k, v in jm.state_dict().items()})
        tm.eval()
        ids = np.random.RandomState(3).randint(0, CFG['vocab_size'],
                                               (2, 512))
        jlogits = np.asarray(jm(paddle.to_tensor(ids.astype(np.int32)))
                             .numpy())
        path = str(tmp_path_factory.mktemp('gpt') / 'gpt')
        tpt.jit.save(tm, path, input_spec=[InputSpec([2, 512], 'int64',
                                                      'input_ids')])
        return tm, torch.from_numpy(ids), jlogits, path


def test_roundtrip_bitwise_and_against_jax(saved):
    tm, ids, jlogits, path = saved
    loaded = tpt.jit.load(path, device='cpu')
    with torch.no_grad():
        got = loaded(ids)
        want = tm(ids)
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), jlogits, rtol=1e-4, atol=1e-4)
    for (name, a), b in zip(tm.state_dict().items(),
                            loaded.state_dict().values()):
        assert torch.equal(a, b), name
    # the tied head stays tied
    assert loaded._layer.lm_head is None
    assert os.path.exists(path + '.pdiparams.manifest')


def test_exported_program_runs_to_the_same_logits(saved):
    tm, ids, _, path = saved
    loaded = tpt.jit.load(path, device='cpu')
    program = loaded.exported_program()
    names = {n.target.name() for n in program.graph.nodes
             if n.op == 'call_function' and hasattr(n.target, 'name')}
    assert 'paddle_tpu_torch::flash_fwd' in names
    got = loaded.run_exported(ids)
    with torch.no_grad():
        want = tm(ids)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_artifact_meta_and_version_gate(saved, tmp_path):
    _, _, _, path = saved
    with open(path + '.pdmodel', 'rb') as f:
        payload = pickle.load(f)
    meta = payload['meta']
    assert meta['format_version'] == tpt.jit._FORMAT_VERSION == (1, 0)
    assert meta['framework_version'] == tpt.__version__
    assert meta['torch_version'] == torch.__version__
    assert meta['op_versions'] == opv.snapshot()
    assert meta['input_spec'] == [((2, 512), 'int64', 'input_ids')]
    assert 'stablehlo' not in meta and meta['exported_program']
    # a newer major refuses to load, an older one warns
    other = str(tmp_path / 'gpt')
    for suffix in ('.pdiparams', '.pdiparams.manifest'):
        with open(path + suffix, 'rb') as f, open(other + suffix, 'wb') as g:
            g.write(f.read())
    for major, expect in ((2, 'raise'), (0, 'warn')):
        payload['meta']['format_version'] = (major, 0)
        with open(other + '.pdmodel', 'wb') as f:
            pickle.dump(payload, f)
        if expect == 'raise':
            with pytest.raises(RuntimeError, match='NEWER framework'):
                tpt.jit.load(other, device='cpu')
        else:
            with pytest.warns(UserWarning, match='older format'):
                tpt.jit.load(other, device='cpu')


def test_op_version_gate(saved, tmp_path):
    """tests/test_op_version.py on the port's registry, a copy of the JAX
    package's, and on its artifacts."""
    assert opv.get_op_version('some_unregistered_op') == 1
    assert opv.snapshot().get('flash_attention', 0) >= 2
    opv.check_compatible(opv.snapshot())
    newer = {'flash_attention': opv.get_op_version('flash_attention') + 1}
    with pytest.raises(opv.OpVersionError, match='newer|upgrade'):
        opv.check_compatible(newer, artifact='m')
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter('always')
        opv.check_compatible({'flash_attention': 1}, artifact='m')
    assert any('version' in str(x.message) for x in w)
    from paddle_tpu.framework import op_version as jopv
    assert opv.snapshot() == jopv.snapshot()

    _, _, _, path = saved
    with open(path + '.pdmodel', 'rb') as f:
        payload = pickle.load(f)
    payload['meta']['op_versions'] = dict(
        payload['meta']['op_versions'],
        flash_attention=opv.get_op_version('flash_attention') + 5)
    other = str(tmp_path / 'gpt')
    for suffix in ('.pdiparams', '.pdiparams.manifest'):
        with open(path + suffix, 'rb') as f, open(other + suffix, 'wb') as g:
            g.write(f.read())
    with open(other + '.pdmodel', 'wb') as f:
        pickle.dump(payload, f, protocol=4)
    with pytest.raises(opv.OpVersionError):
        tpt.jit.load(other, device='cpu')


def test_load_in_a_fresh_process(saved):
    """The architecture unpickles in a process that imported only
    paddle_tpu_torch (the custom ops register at import), and its logits
    are the saved model's."""
    tm, ids, _, path = saved
    code = (
        'import sys, torch\n'
        'torch.set_num_threads(int(sys.argv[3]))\n'
        'import paddle_tpu_torch as tpt\n'
        'm = tpt.jit.load(sys.argv[1], device="cpu")\n'
        'ids = torch.arange(1024).reshape(2, 512) % 256\n'
        'with torch.no_grad():\n'
        '    out = m(ids)\n'
        'assert not any(n == "jax" or n.startswith(("jax.", "paddle_tpu.")) '
        'or n == "paddle_tpu" for n in sys.modules)\n'
        'torch.save(out, sys.argv[2])\n')
    out_path = path + '.logits.pt'
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, '-c', code, path, out_path,
                          str(torch.get_num_threads())],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    ids = torch.arange(1024).reshape(2, 512) % 256
    with torch.no_grad():
        assert torch.equal(torch.load(out_path), tm(ids))


def test_save_strips_hooks_and_the_to_static_wrapper(tmp_path):
    layer = tpt.nn.Linear(4, 3, device='cpu',
                          weight_attr=tpt.ParamAttr(learning_rate=0.5))
    seen = []
    layer.register_forward_hook(lambda *a: seen.append(1))
    tpt.jit.to_static(layer)
    x = torch.randn(2, 4)
    want = layer(x)
    path = str(tmp_path / 'lin')
    tpt.jit.save(layer, path, input_spec=[x])
    loaded = tpt.jit.load(path, device='cpu')
    assert 'forward' not in vars(loaded._layer)
    assert not loaded._layer._forward_hooks
    calls = len(seen)
    assert torch.equal(loaded(x), want)
    assert len(seen) == calls                # the copy runs no hook
    assert loaded._layer.weight.optimize_attr['learning_rate'] == 0.5
    # the saved layer keeps its wrapper and hook
    assert isinstance(vars(layer)['forward'], tpt.jit.StaticFunction)
    with pytest.raises(ValueError, match='input_spec'):
        tpt.jit.save(layer, path)
        tpt.jit.load(path, device='cpu').exported_program()


def test_mlp_roundtrip_against_jax(tmp_path):
    paddle.seed(1)
    jm = paddle.nn.Sequential(paddle.nn.Linear(8, 16), paddle.nn.ReLU(),
                              paddle.nn.Linear(16, 4))
    tm = torch.nn.Sequential(tpt.nn.Linear(8, 16, device='cpu'),
                             torch.nn.ReLU(),
                             tpt.nn.Linear(16, 4, device='cpu'))
    tm.load_state_dict({k: torch.from_numpy(np.array(v.numpy()))
                        for k, v in jm.state_dict().items()})
    paddle.jit.save(jm, str(tmp_path / 'j'))
    tpt.jit.save(tm, str(tmp_path / 't'))
    jl = paddle.jit.load(str(tmp_path / 'j'))
    tl = tpt.jit.load(str(tmp_path / 't'), device='cpu')
    x = np.random.RandomState(1).randn(4, 8).astype(np.float32)
    np.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jl(paddle.to_tensor(x)).numpy()),
                               rtol=1e-6, atol=1e-6)
