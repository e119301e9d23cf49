"""The port's GPT slice (paddle_tpu_torch/text/models/gpt.py) against the
JAX package's: a small GPT built in JAX, carried across with
load_paddle_tpu_state, must give the same logits and token-identical greedy
generate() output. The JAX prefill at 512 tokens runs the Pallas forward
kernel through the interpreter, under strict mode."""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
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
from paddle_tpu_torch import nn as tpt_nn
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
        'print(" ".join(sorted(m for m in sys.modules '
        'if m.startswith("paddle_tpu_torch."))))\n')
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    # the walk reached the serving and monitor modules of slice 4, the
    # registry and fabric modules of slice 6, the training shell of slice 9,
    # the compiled mode and inference engine of slice 10, the static
    # graph of slice 11, the parameter server and graph engine of slice
    # 12, the collective training of slice 13, slice 14's nn, text and
    # tensor modules, slice 15's observability plane and slice 17's
    # launcher, elastic membership, auto_parallel and norms, slice 18's
    # convolutions, pools, weight norms and vision package, slice 19's
    # losses, extension functionals, RNN layers and beam search, and slice
    # 20's detection ops and PP-YOLOv2, slice 21's slim package,
    # nn.quant and the rest of incubate, slice 22's library surface, and
    # slice 23's exporter, C API bridge and crypto
    imported = set(res.stdout.split())
    for mod in SLICE4_MODULES + SLICE6_MODULES + SLICE7_MODULES + \
            SLICE9_MODULES + SLICE10_MODULES + SLICE11_MODULES + \
            SLICE12_MODULES + SLICE13_MODULES + SLICE14_MODULES + \
            SLICE15_MODULES + SLICE17_MODULES + SLICE18_MODULES + \
            SLICE19_MODULES + SLICE20_MODULES + SLICE21_MODULES + \
            SLICE22_MODULES + SLICE23_MODULES:
        assert 'paddle_tpu_torch.' + mod in imported, mod


SLICE17_MODULES = ('distributed.launch', 'distributed.launch.main',
                   'distributed.cloud_utils', 'distributed.fleet.elastic',
                   'distributed.auto_parallel',
                   'distributed.auto_parallel.planner',
                   'distributed.auto_parallel.tuner',
                   'distributed.auto_parallel.audit',
                   'distributed.meta_parallel.sync_bn', 'nn.layer.norm',
                   'nn.functional.norm')
SLICE18_MODULES = ('nn.functional.conv', 'nn.functional.pooling',
                   'nn.functional.common', 'nn.functional.resize',
                   'nn.layer.conv', 'nn.layer.pooling', 'nn.layer.common',
                   'nn.utils_weight_norm', 'vision', 'vision.models',
                   'vision.models._utils', 'vision.models.lenet',
                   'vision.models.resnet', 'vision.models.vgg',
                   'vision.models.mobilenet', 'vision.transforms',
                   'vision.transforms.functional',
                   'vision.transforms.transforms', 'vision.datasets')
SLICE19_MODULES = ('nn.functional.loss', 'nn.functional.extension',
                   'nn.layer.loss', 'nn.layer.rnn', 'nn.decode',
                   'static.nn')
SLICE20_MODULES = ('vision.ops', 'vision.detection', 'vision.models.yolo')
SLICE21_MODULES = ('slim', 'slim.quant_layers', 'slim.qat', 'slim.ptq',
                   'slim.cal_kl_threshold', 'slim.weight_only', 'nn.quant',
                   'incubate', 'incubate.asp', 'incubate.optimizer',
                   'incubate.auto_checkpoint')
SLICE22_MODULES = ('batch', 'hub', 'sysconfig', 'dataset', 'distribution',
                   'framework.debug', 'nn.functional.sparse_attention',
                   'text.datasets', 'utils', 'utils.cpp_extension',
                   'utils.cpp_extension.extension_utils',
                   'utils.op_benchmark')
SLICE23_MODULES = ('onnx', 'capi', 'capi.bridge', 'framework.crypto')
SLICE4_MODULES = ('serving', 'serving.engine', 'serving.paged_engine',
                  'serving.kv_cache', 'serving.scheduler', 'serving.metrics',
                  'monitor', 'monitor.registry', 'monitor.tracing',
                  'monitor.events', 'monitor.telemetry', 'monitor.perf',
                  'monitor.perf.timeline')
SLICE6_MODULES = ('framework.io_save', 'framework.compile_cache',
                  'distributed.ps.wire', 'distributed.resilience',
                  'testing.chaos', 'serving.registry',
                  'serving.registry.registry', 'serving.registry.hosting',
                  'serving.fabric.protocol', 'serving.fabric.presets',
                  'serving.fabric.worker', 'serving.fabric.socket_replica',
                  'serving.fabric.artifacts', 'serving.fabric.directory')
SLICE7_MODULES = ('amp', 'amp.auto_cast', 'amp.grad_scaler', 'regularizer',
                  'optimizer.lr', 'optimizer.optimizers', 'nn.clip',
                  'nn.layer.layers', 'nn.layer.loss', 'distributed.fleet',
                  'distributed.fleet.utils', 'framework.functional')
SLICE9_MODULES = ('io', 'io.dataset', 'io.sampler', 'io.dataloader',
                  'metric', 'monitor.runtime', 'distributed.checkpoint',
                  'distributed.supervisor', 'hapi', 'hapi.callbacks',
                  'hapi.model', 'data', 'data.shards', 'data.pipeline',
                  'nn.initializer', 'framework.random', 'framework.device')
SLICE10_MODULES = ('autograd', 'jit', 'jit.error', 'static',
                   'static.input_spec', 'inference', 'inference.predictor',
                   'framework.op_version')
SLICE11_MODULES = ('static', 'static.nn', 'framework.recorder',
                   'inference.fluid_program')
SLICE13_MODULES = ('distributed', 'distributed.env', 'distributed.spawn',
                   'distributed.collective', 'distributed.topology',
                   'distributed.parallel', 'distributed.strategy',
                   'distributed.sp', 'distributed.meta_parallel',
                   'distributed.meta_parallel.mp_layers',
                   'distributed.meta_parallel.random_ctrl',
                   'distributed.meta_parallel.parallel_base',
                   'distributed.fleet.distributed_strategy',
                   'distributed.fleet.meta_optimizers',
                   'ops.ring_attention')
SLICE14_MODULES = ('nn.functional.activation', 'nn.layer.activation',
                   'nn.layer.container', 'nn.layer.distance',
                   'nn.layer.transformer', 'text.models.bert', 'tensor',
                   'tensor._helpers', 'tensor.attribute', 'tensor.creation',
                   'tensor.einsum', 'tensor.inplace', 'tensor.linalg',
                   'tensor.logic', 'tensor.manipulation', 'tensor.math',
                   'tensor.random', 'tensor.search', 'tensor.stat',
                   'framework.flags', 'framework.dtype')
SLICE15_MODULES = ('monitor.federation', 'monitor.alerts',
                   'monitor.server', 'monitor.perf.watchdog',
                   'monitor.perf.costmodel', 'profiler',
                   'capacity.simulator', 'testing.lockwatch')
SLICE12_MODULES = ('native', 'native.datafeed', 'native.embedding_table',
                   'native.graph_store', 'distributed.ps',
                   'distributed.ps.embedding_service', 'distributed.ps.tables',
                   'distributed.ps.communicator', 'distributed.ps.dataset',
                   'distributed.ps.trainer', 'distributed.ps.heter',
                   'distributed.ps.runtime', 'distributed.graph_service',
                   'distributed.graph_learning', 'distributed.index_dataset',
                   'distributed.fleet', 'distributed.fleet.data_generator')


def _port_files():
    files = [os.path.join(REPO, n) for n in ('chip_smoke.py',
                                             'fleet_probe.py',
                                             'tests/onnx_numpy.py')]
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
    scanned = {os.path.relpath(f, REPO) for f in _port_files()}
    for mod in SLICE4_MODULES + SLICE6_MODULES + SLICE7_MODULES + \
            SLICE9_MODULES + SLICE10_MODULES + SLICE11_MODULES + \
            SLICE12_MODULES + SLICE13_MODULES + SLICE14_MODULES + \
            SLICE15_MODULES + SLICE20_MODULES + SLICE21_MODULES + \
            SLICE22_MODULES + SLICE23_MODULES:
        path = os.path.join('paddle_tpu_torch', *mod.split('.'))
        assert path + '.py' in scanned or \
            os.path.join(path, '__init__.py') in scanned, mod
    assert not offenders, offenders


def test_native_loader_builds_in_the_port_only():
    """The port's g++ loader compiles its own copies of the three sources
    into paddle_tpu_torch/_build/native/ and opens, runs and loads nothing
    under paddle_tpu/ (an audit hook records every open, subprocess and
    dlopen of a fresh interpreter)."""
    code = (
        'import os, sys\n'
        'seen = []\n'
        'def hook(event, args):\n'
        '    if event in ("open", "subprocess.Popen", "ctypes.dlopen"):\n'
        '        seen.append(repr(args))\n'
        'sys.addaudithook(hook)\n'
        'from paddle_tpu_torch import native\n'
        'for name in ("datafeed", "embedding_table", "graph_store"):\n'
        '    lib = native.load_library(name)\n'
        '    print("LIB", lib._name)\n'
        'with open("/proc/self/maps") as f:\n'
        '    print("MAPS", " ".join(l.split()[-1] for l in f '
        'if ".so" in l))\n'
        'print("SEEN", " ".join(seen))\n')
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    build = os.path.join(REPO, 'paddle_tpu_torch', '_build', 'native') + \
        os.sep
    libs = [l.split(' ', 1)[1] for l in res.stdout.splitlines()
            if l.startswith('LIB ')]
    assert len(libs) == 3 and all(l.startswith(build) for l in libs), libs
    jax_pkg = os.path.join(REPO, 'paddle_tpu') + os.sep
    for line in res.stdout.splitlines():
        assert jax_pkg not in line, line
    for name in ('datafeed', 'embedding_table', 'graph_store'):
        # the port's sources are copies of the JAX package's
        with open(os.path.join(REPO, 'paddle_tpu', 'native',
                               name + '.cc'), 'rb') as a, \
                open(os.path.join(REPO, 'paddle_tpu_torch', 'native',
                                  name + '.cc'), 'rb') as b:
            assert a.read() == b.read(), name


# ---- the JAX package's signatures ---------------------------------------


def test_explicit_position_ids_match_jax(pair):
    jm, tm, _ = pair
    ids = _ids(2, 12, seed=6)
    pos = np.array([np.arange(7, 19), np.arange(30, 42)])
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), torch.from_numpy(pos)).numpy()
    want = np.asarray(jm(paddle.to_tensor(ids),
                         paddle.to_tensor(pos)).numpy())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # positions change the logits
    with torch.no_grad():
        plain = tm(torch.from_numpy(ids)).numpy()
    assert not np.allclose(got, plain)


def test_tuple_cache_matches_jax(pair):
    """The growing (k, v) cache: a 9-token prefill from an empty past, then
    3 more tokens, with explicit positions (which the JAX package needs
    here); each returns the concatenated (k, v)."""
    jm, tm, _ = pair
    ids = _ids(2, 12, seed=7)
    c = SMALL['hidden_size'] // SMALL['num_heads']
    empty = np.zeros((2, 0, SMALL['num_heads'], c), np.float32)
    jc = [(paddle.to_tensor(empty), paddle.to_tensor(empty))
          for _ in range(SMALL['num_layers'])]
    tc = [(torch.from_numpy(empty), torch.from_numpy(empty))
          for _ in range(SMALL['num_layers'])]
    for lo, hi in ((0, 9), (9, 12)):
        pos = np.arange(lo, hi)[None].repeat(2, 0)
        j_logits, jc = jm(paddle.to_tensor(ids[:, lo:hi]),
                          paddle.to_tensor(pos), caches=jc)
        with torch.no_grad():
            t_logits, tc = tm(torch.from_numpy(ids[:, lo:hi]),
                              torch.from_numpy(pos), caches=tc)
        np.testing.assert_allclose(t_logits.numpy(),
                                   np.asarray(j_logits.numpy()),
                                   rtol=1e-4, atol=1e-4)
        for (tk, tv), (jk, jv) in zip(tc, jc):
            assert tuple(tk.shape) == (2, hi, SMALL['num_heads'], c)
            np.testing.assert_allclose(tk.numpy(), np.asarray(jk.numpy()),
                                       rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv.numpy()),
                                       rtol=1e-4, atol=1e-4)
    # without positions the tuple cache continues from the past's length
    with torch.no_grad():
        again, _ = tm(torch.from_numpy(ids[:, 9:12]),
                      caches=[(k[:, :9], v[:, :9]) for k, v in tc])
    np.testing.assert_allclose(again.numpy(), t_logits.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_keyword_constructor_and_int32_generate():
    tm = tgpt.GPTForCausalLM(device='cpu', seed=3, **SMALL)
    assert tm.config.vocab_size == SMALL['vocab_size']
    assert tm.config.num_layers == len(tm.gpt.h) == SMALL['num_layers']
    body = tgpt.GPTModel(device='cpu', **SMALL)
    assert body.config.hidden_size == SMALL['hidden_size']
    ids = _ids(1, 5, seed=8)
    out = tm.eval().generate(ids, max_new_tokens=3)
    assert out.dtype == torch.int32 and tuple(out.shape) == (1, 8)
    assert tm.generate(ids, max_new_tokens=0).dtype == torch.int32


# ---- per-block recompute ---------------------------------------------------


def _train_grads(model, ids):
    model.train()
    loss = model.loss(model(ids), ids)
    loss.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def test_block_recompute_grads_match_jax():
    """GPTConfig.recompute: each block checkpointed (fleet.utils.recompute)
    on both sides; the loss and every gradient as in the JAX package's."""
    import jax
    from paddle_tpu.framework import functional as jfm
    cfg = dict(SMALL, recompute=True)
    paddle.seed(31)
    jm = JGPT(JConfig(**cfg))
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**cfg), device='cpu')
    tgpt.load_paddle_tpu_state(tm, {k: np.asarray(v.numpy())
                                    for k, v in jm.state_dict().items()})
    ids = _ids(2, 64, seed=9)

    def f(params):
        loss, _ = jfm.functional_call(
            jm, params, {}, args=(jax.numpy.asarray(ids),), training=True,
            post_fn=jfm.make_loss_post(lambda o, l: jm.loss(o, l),
                                       (jax.numpy.asarray(ids),)))
        return loss

    want_loss, want = jax.jit(jax.value_and_grad(f))(jfm.extract_params(jm))
    got_loss, got = _train_grads(tm, torch.from_numpy(ids))
    np.testing.assert_allclose(got_loss, float(want_loss), rtol=1e-5)
    for name, w in want.items():
        w = np.asarray(w)
        err = np.abs(got[name].numpy() - w).max()
        assert err <= 1e-4 * max(np.abs(w).max(), 1e-6), (name, err)


def test_block_recompute_with_dropout_draws_one_mask():
    """With dropout (the blocks' and the attention probabilities', which
    _sdpa_ref checkpoints inside the block's checkpoint), the recompute
    draws the forward's masks again: loss and grads equal those of the
    same run without recompute, bit for bit."""
    cfg = tgpt.GPTConfig(**dict(SMALL, dropout=0.1))
    model = tgpt.GPTForCausalLM(cfg, device='cpu', seed=3)
    ids = torch.from_numpy(_ids(2, 64, seed=10))
    runs = []
    for flag in (False, True):
        model.enable_recompute(flag)
        torch.manual_seed(77)
        runs.append(_train_grads(model, ids))
    model.enable_recompute(False)
    assert runs[0][0] == runs[1][0]
    for name, g in runs[0][1].items():
        assert torch.equal(runs[1][1][name], g), name
    torch.manual_seed(78)
    assert _train_grads(model, ids)[0] != runs[0][0]  # masks did change


def test_fleet_recompute_of_module_and_function():
    from paddle_tpu_torch.distributed.fleet import recompute
    lin = tpt_nn.Linear(4, 3, device='cpu')
    x = torch.randn(5, 4, requires_grad=True)
    out = recompute(lin, x, preserve_rng_state=True)
    out.square().sum().backward()
    want_w, want_x = lin.weight.grad.clone(), x.grad.clone()
    lin.weight.grad, x.grad = None, None
    lin(x).square().sum().backward()
    assert torch.equal(lin.weight.grad, want_w)
    assert torch.equal(x.grad, want_x)
    y = torch.randn(3, requires_grad=True)
    recompute(lambda a, k=1.0: (a * k).exp(), y, k=2.0).sum().backward()
    torch.testing.assert_close(y.grad, 2 * (2 * y.detach()).exp())


def test_gpt3_13b_is_the_jax_packages_configuration():
    from paddle_tpu.text.models.gpt import GPTConfig as JConfig
    want, got = vars(JConfig.gpt3_13b()), vars(tgpt.GPTConfig.gpt3_13b())
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key] == value, key
    assert (got['vocab_size'], got['hidden_size'], got['num_layers'],
            got['num_heads'], got['max_position_embeddings']) == \
        (50304, 5120, 40, 40, 2048)
