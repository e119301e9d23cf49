"""The port's GPT slice (paddle_tpu_torch/text/models/gpt.py) against the
JAX package's: a small GPT built in JAX, carried across with
load_paddle_tpu_state, must give the same logits and token-identical greedy
generate() output. The JAX prefill at 512 tokens runs the Pallas forward
kernel through the interpreter, under strict mode."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.text.models.gpt import GPTConfig as JConfig
from paddle_tpu.text.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.text.models import gpt as tgpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
             max_position_embeddings=640, dropout=0.0)


@pytest.fixture(autouse=True)
def _interpret_strict(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_FLASH_INTERPRET', '1')
    monkeypatch.setenv('PADDLE_TPU_FLASH_STRICT', '1')


@pytest.fixture(scope='module')
def pair():
    paddle.seed(11)
    jm = JGPT(JConfig(**SMALL))
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**SMALL), device='cpu', seed=5)
    tgpt.load_paddle_tpu_state(tm, state)
    tm.eval()
    return jm, tm, state


def _ids(b, n, seed=0):
    return np.random.RandomState(seed).randint(0, SMALL['vocab_size'],
                                               (b, n))


def test_nocache_logits_match_at_seq_512(pair):
    jm, tm, _ = pair
    ids = _ids(2, 512)
    before = tfa.counts['flash']
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    assert tfa.counts['flash'] == before + SMALL['num_layers']
    want = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    assert got.shape == (2, 512, SMALL['vocab_size'])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_generate_token_identical_prompt_512(pair):
    jm, tm, _ = pair
    ids = _ids(2, 512, seed=1)
    before = tfa.counts['flash']
    got = tm.generate(ids, max_new_tokens=8).numpy()
    # one flash call per layer for the prefill; decode is masked attention
    assert tfa.counts['flash'] == before + SMALL['num_layers']
    want = np.asarray(jm.generate(paddle.to_tensor(ids),
                                  max_new_tokens=8).numpy())
    assert got.shape == (2, 520)
    np.testing.assert_array_equal(got, want)


def test_generate_token_identical_short_prompt(pair):
    jm, tm, _ = pair
    ids = _ids(2, 16, seed=2)
    before = tfa.counts['flash']
    got = tm.generate(ids, max_new_tokens=8).numpy()
    assert tfa.counts['flash'] == before
    want = np.asarray(jm.generate(paddle.to_tensor(ids),
                                  max_new_tokens=8).numpy())
    np.testing.assert_array_equal(got, want)


def test_generate_sampling_is_seeded(pair):
    _, tm, _ = pair
    ids = _ids(2, 16, seed=3)
    a = tm.generate(ids, max_new_tokens=6, do_sample=True, top_k=20, seed=4)
    b = tm.generate(ids, max_new_tokens=6, do_sample=True, top_k=20, seed=4)
    assert torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < SMALL['vocab_size']
    assert torch.equal(tm.generate(ids, max_new_tokens=0),
                       torch.from_numpy(ids))


def test_num_params_and_config_match(pair):
    jm, tm, _ = pair
    assert tm.num_params() == jm.num_params()
    j, t = JConfig.gpt2_small(), tgpt.GPTConfig.gpt2_small()
    assert j.tie_word_embeddings and not j.use_rmsnorm
    for key in ('vocab_size', 'hidden_size', 'num_layers', 'num_heads',
                'intermediate_size', 'max_position_embeddings',
                'layer_norm_epsilon', 'dropout'):
        assert getattr(t, key) == getattr(j, key), key


def test_generate_rejects_too_long(pair):
    _, tm, _ = pair
    with pytest.raises(ValueError, match='max_position_embeddings'):
        tm.generate(_ids(1, 600), max_new_tokens=41)


def test_static_cache_overflow_raises(pair):
    _, tm, _ = pair
    caches = [tgpt.GPTStaticCache.empty(1, 4, 2, 64, device='cpu')
              for _ in range(SMALL['num_layers'])]
    with torch.no_grad(), pytest.raises(ValueError, match='overflow'):
        tm(torch.from_numpy(_ids(1, 5)), caches=caches)


@pytest.mark.parametrize('fault', ['missing', 'extra', 'shape'])
def test_load_state_rejects_mismatch(pair, fault):
    _, _, state = pair
    bad = dict(state)
    if fault == 'missing':
        del bad['gpt.h.1.mlp.fc_in.bias']
        err, match = KeyError, 'missing'
    elif fault == 'extra':
        bad['lm_head.weight'] = np.zeros((128, 512), np.float32)
        err, match = KeyError, 'extra'
    else:
        bad['gpt.wpe.weight'] = np.zeros((512, 128), np.float32)
        err, match = ValueError, 'shape'
    model = tgpt.GPTForCausalLM(tgpt.GPTConfig(**SMALL), device='cpu')
    first = model.gpt.wte.weight.detach().clone()
    with pytest.raises(err, match=match):
        tgpt.load_paddle_tpu_state(model, bad)
    assert torch.equal(model.gpt.wte.weight, first)  # nothing copied


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        tgpt.GPTForCausalLM(tgpt.GPTConfig(**SMALL))


def test_port_imports_neither_jax_nor_paddle_tpu():
    code = (
        'import importlib, pkgutil, sys\n'
        'import paddle_tpu_torch, chip_smoke\n'
        'for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, '
        '"paddle_tpu_torch."):\n'
        '    importlib.import_module(m.name)\n'
        'bad = sorted(m for m in sys.modules if m == "jax" or '
        'm.startswith("jax.") or m == "paddle_tpu" or '
        'm.startswith("paddle_tpu."))\n'
        'assert not bad, bad\n'
        'print("ok")\n')
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == 'ok'


def _port_files():
    files = [os.path.join(REPO, 'chip_smoke.py')]
    for root, _, names in os.walk(os.path.join(REPO, 'paddle_tpu_torch')):
        files += [os.path.join(root, n) for n in names if n.endswith('.py')]
    return files


def test_port_sources_import_neither_jax_nor_paddle_tpu():
    offenders = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or '']
            else:
                continue
            for name in names:
                top = name.split('.')[0]
                if top in ('jax', 'jaxlib', 'paddle_tpu'):
                    offenders.append('%s: %s' % (path, name))
    assert len(_port_files()) > 10
    assert not offenders, offenders
