"""The port's inference engine (paddle_tpu_torch/inference/) against the
JAX package's.

tests/test_inference.py's cases, each against the JAX Predictor on the same
weights: the round trip through the zero-copy handles and the list API with
a second signature (on a 2-layer, hidden-64 GPT at seq 512, so the
compiled program runs the flash custom op), bf16 precision and named
inputs with their validation (on an MLP). Then the registry-backed
PredictorPool, decode_engine / decode_gateway token-identical to the
port's engines on the same model, Model.save(training=False) served by a
Predictor, and the Config surface. The port's Predictor runs on the CPU
here through Config.disable_gpu(); its default is the card.
"""
import os

import numpy as np
import pytest
import torch
import torch._inductor.config as inductor_config

import paddle_tpu as paddle
import paddle_tpu_torch as tpt
from paddle_tpu import inference as jinf
from paddle_tpu.static import InputSpec as JSpec
from paddle_tpu.text.models.gpt import GPTConfig as JConfig
from paddle_tpu.text.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.static import InputSpec
from paddle_tpu_torch.text.models import gpt as tgpt

F32 = dict(rtol=1e-4, atol=1e-5)
GPT_CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=1,
               max_position_embeddings=512, dropout=0.0)


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_FLASH_INTERPRET', '1')
    monkeypatch.setenv('PADDLE_TPU_FLASH_STRICT', '1')
    monkeypatch.setattr(inductor_config, 'compile_threads', 1)


def _cpu_config(path):
    config = tinf.Config(path)
    config.disable_gpu()
    return config


def _mlp_pair(seed, sizes=(8, 16, 4)):
    """The same MLP in both packages (Linear weights are [in, out] in
    both)."""
    paddle.seed(seed)
    layers, tlayers = [], []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        if i:
            layers.append(paddle.nn.ReLU())
            tlayers.append(torch.nn.ReLU())
        layers.append(paddle.nn.Linear(a, b))
        tlayers.append(tpt.nn.Linear(a, b, device='cpu'))
    jm = paddle.nn.Sequential(*layers)
    tm = torch.nn.Sequential(*tlayers)
    tm.load_state_dict({k: torch.from_numpy(np.array(v.numpy()))
                        for k, v in jm.state_dict().items()})
    jm.eval()
    tm.eval()
    return jm, tm


def test_predictor_roundtrip_gpt_against_jax(tmp_path):
    paddle.seed(0)
    jm = JGPT(JConfig(**GPT_CFG))
    jm.eval()
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**GPT_CFG), device='cpu')
    tgpt.load_paddle_tpu_state(tm, {k: np.asarray(v.numpy())
                                    for k, v in jm.state_dict().items()})
    paddle.jit.save(jm, str(tmp_path / 'j'),
                    input_spec=[JSpec([2, 512], 'int32')])
    tpt.jit.save(tm, str(tmp_path / 't'),
                 input_spec=[InputSpec([2, 512], 'int64')])
    jpred = jinf.create_predictor(jinf.Config(str(tmp_path / 'j')))
    tpred = tinf.create_predictor(_cpu_config(str(tmp_path / 't')))
    ids = np.random.RandomState(0).randint(0, 256, (2, 512))

    # zero-copy style API
    for pred, x in ((jpred, ids.astype(np.int32)), (tpred, ids)):
        name = pred.get_input_names()[0]
        pred.get_input_handle(name).copy_from_cpu(x)
        pred.run()
    before = tfa.counts['flash']
    jout = jpred.get_output_handle(jpred.get_output_names()[0]).copy_to_cpu()
    tout = tpred.get_output_handle('output_0').copy_to_cpu()
    np.testing.assert_allclose(tout, jout, **F32)
    assert tpred.get_output_handle('output_0').shape() == [2, 512, 256]

    # the list API: the same signature runs its program again, a second
    # shape compiles once more
    compiles = tpred.compile_count()
    assert compiles == 1
    tout2 = tpred.run([ids])[0]
    assert tfa.counts['flash'] == before + GPT_CFG['num_layers']
    assert tpred.compile_count() == compiles
    assert np.array_equal(tout2, tout)
    jout1 = jpred.run([ids[:1].astype(np.int32)])[0]
    tout1 = tpred.run([ids[:1]])[0]
    assert tpred.compile_count() == compiles + 1
    np.testing.assert_allclose(tout1, jout1, **F32)
    # the exported program of the artifact agrees
    loaded = tpt.jit.load(str(tmp_path / 't'), device='cpu')
    np.testing.assert_allclose(
        loaded.run_exported(torch.from_numpy(ids)).numpy(), tout, **F32)


def test_predictor_bf16_precision(tmp_path):
    jm, tm = _mlp_pair(1)
    paddle.jit.save(jm, str(tmp_path / 'j'))
    tpt.jit.save(tm, str(tmp_path / 't'))
    jconfig = jinf.Config(str(tmp_path / 'j'))
    tconfig = _cpu_config(str(tmp_path / 't'))
    for config, pkg in ((jconfig, jinf), (tconfig, tinf)):
        config.enable_tensorrt_engine(
            precision_mode=pkg.PrecisionType.Bfloat16)
    x = np.random.RandomState(1).standard_normal((4, 8)).astype(np.float32)
    jout = jinf.create_predictor(jconfig).run([x])[0].astype(np.float32)
    tpred = tinf.create_predictor(tconfig)
    tout = tpred.run([x])[0]
    assert next(tpred._layer.parameters()).dtype == torch.bfloat16
    ref = np.asarray(jm(paddle.to_tensor(x)).numpy())
    np.testing.assert_allclose(tout, ref, atol=0.1)
    np.testing.assert_allclose(tout, jout, atol=0.1)


def test_predictor_named_inputs_and_validation(tmp_path):
    # inputs resolved by the saved spec's names; unknown names rejected at
    # copy_from_cpu; run() fails loudly on missing inputs
    jm, tm = _mlp_pair(2, sizes=(8, 4))
    paddle.jit.save(jm, str(tmp_path / 'j'),
                    input_spec=[JSpec([2, 8], name='features')])
    tpt.jit.save(tm, str(tmp_path / 't'),
                 input_spec=[InputSpec([2, 8], name='features')])
    jpred = jinf.create_predictor(jinf.Config(str(tmp_path / 'j')))
    tpred = tinf.create_predictor(_cpu_config(str(tmp_path / 't')))
    x = np.random.RandomState(2).standard_normal((2, 8)).astype(np.float32)
    outs = []
    for pred in (jpred, tpred):
        assert pred.get_input_names() == ['features']
        with pytest.raises(ValueError):
            pred.get_input_handle('bogus').copy_from_cpu(np.zeros((2, 8)))
        with pytest.raises(ValueError):
            pred.run()
        pred.get_input_handle('features').copy_from_cpu(x)
        pred.run()
        outs.append(pred.get_output_handle('output_0').copy_to_cpu())
    np.testing.assert_allclose(outs[1], outs[0], **F32)


def test_predictor_without_spec_takes_positional_names(tmp_path):
    jm, tm = _mlp_pair(3)
    tpt.jit.save(tm, str(tmp_path / 't'))
    tpred = tinf.create_predictor(_cpu_config(str(tmp_path / 't')))
    assert tpred.get_input_names() == ['input_0']
    with pytest.raises(ValueError, match='unknown input'):
        tpred.get_input_handle('x').copy_from_cpu(np.zeros((2, 8)))
    x = np.random.RandomState(3).standard_normal((2, 8)).astype(np.float32)
    tpred.get_input_handle('input_0').copy_from_cpu(x)
    tpred.run()
    np.testing.assert_allclose(
        tpred.get_output_handle('output_0').copy_to_cpu(),
        np.asarray(jm(paddle.to_tensor(x)).numpy()), **F32)
    # clone: its own handles and programs, the same function
    other = tpred.clone()
    np.testing.assert_allclose(other.run([x])[0], tpred.run([x])[0],
                               rtol=0, atol=0)


def test_predictor_pool_registry_backed(tmp_path):
    """A jit.save artifact registered by its CRC-manifested .pdiparams; the
    pool follows the registry's serving pointer."""
    from paddle_tpu_torch.serving import ModelRegistry
    jm1, tm1 = _mlp_pair(4)
    jm2, tm2 = _mlp_pair(5)
    reg = ModelRegistry()
    for version, tm in (('v1', tm1), ('v2', tm2)):
        tpt.jit.save(tm, str(tmp_path / version))
        reg.register('mlp', version, str(tmp_path / version) + '.pdiparams')
    config = tinf.Config()
    config.disable_gpu()
    pool = tinf.PredictorPool(config, size=2, registry=reg, model='mlp')
    assert pool.fingerprint == reg.resolve('mlp').fingerprint
    x = np.random.RandomState(4).standard_normal((3, 8)).astype(np.float32)
    want = np.asarray(jm1(paddle.to_tensor(x)).numpy())
    a, b = pool.retrieve(0), pool.Retrieve(1)
    assert a is not b
    for pred in (a, b):
        np.testing.assert_allclose(pred.run([x])[0], want, **F32)
    with pytest.raises(IndexError):
        pool.retrive(2)
    reg.set_serving('mlp', 'v2')
    pool2 = tinf.PredictorPool(config, registry=reg, model='mlp')
    np.testing.assert_allclose(pool2.retrieve(0).run([x])[0],
                               np.asarray(jm2(paddle.to_tensor(x)).numpy()),
                               **F32)
    assert pool2.fingerprint != pool.fingerprint
    with pytest.raises(ValueError):
        tinf.PredictorPool(registry=reg)


LM_CFG = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
              max_position_embeddings=128, dropout=0.0)


def test_decode_engine_token_identical_to_engines(tmp_path):
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          PagedContinuousBatchingEngine)
    model = tgpt.GPTForCausalLM(tgpt.GPTConfig(**LM_CFG), device='cpu',
                                seed=3)
    model.eval()
    path = str(tmp_path / 'gpt_lm')
    tpt.jit.save(model, path)
    pred = tinf.create_predictor(_cpu_config(path))
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 512, n).tolist() for n in (5, 11, 3)]
    want = ContinuousBatchingEngine(
        model, num_slots=2, max_len=64, prefill_chunk=8,
        decode_block=4).generate(prompts, max_new_tokens=6)
    eng = pred.decode_engine(num_slots=2, max_len=64, prefill_chunk=8,
                             decode_block=4)
    assert eng.generate(prompts, max_new_tokens=6) == want
    paged = pred.decode_engine(num_slots=2, max_len=64, prefill_chunk=8,
                               decode_block=4, paged=True, page_size=8)
    assert isinstance(paged, PagedContinuousBatchingEngine)
    assert paged.generate(prompts, max_new_tokens=6) == want
    with pytest.raises(TypeError, match='paged=True'):
        pred.decode_engine(page_size=8)
    gateway = pred.decode_gateway(replicas=2, num_slots=2, max_len=64,
                                  prefill_chunk=8, decode_block=4)
    try:
        assert gateway.generate(prompts, max_new_tokens=6) == want
    finally:
        gateway.shutdown()


def test_decode_engine_rejects_non_lm(tmp_path):
    _, tm = _mlp_pair(6, sizes=(4, 4))
    tpt.jit.save(tm, str(tmp_path / 'mlp'))
    pred = tinf.create_predictor(_cpu_config(str(tmp_path / 'mlp')))
    with pytest.raises(TypeError, match='causal-LM'):
        pred.decode_engine()


def test_model_save_for_inference_then_predictor(tmp_path):
    _, tm = _mlp_pair(7)
    model = tpt.Model(tm, inputs=[InputSpec([None, 8], 'float32', 'x')])
    model.prepare(optimizer=tpt.optimizer.Adam(
        learning_rate=1e-3, parameters=tm.parameters()),
        loss=torch.nn.functional.mse_loss)
    path = str(tmp_path / 'infer')
    model.save(path, training=False)
    assert os.path.exists(path + '.pdmodel')
    pred = tinf.create_predictor(_cpu_config(path))
    assert pred.get_input_names() == ['x']
    x = np.random.RandomState(7).standard_normal((3, 8)).astype(np.float32)
    pred.get_input_handle('x').copy_from_cpu(x)
    pred.run()
    with torch.no_grad():
        want = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(pred.get_output_handle('output_0')
                               .copy_to_cpu(), want, **F32)


def test_reference_format_artifact_served_by_predictor(tmp_path):
    """A reference-format artifact (a __model__ directory, or a .pdmodel
    ProgramDesc with its combined .pdiparams) is served through
    inference/fluid_program.py, as by the JAX package's Predictor."""
    from test_torch_fluid import _fit_a_line_dir
    d, w, b = _fit_a_line_dir(tmp_path, combined=False)
    comb = _fit_a_line_dir(tmp_path, combined=True)[0]
    (comb / 'm.pdmodel').write_bytes((comb / '__model__').read_bytes())
    (comb / 'm.pdiparams').write_bytes((comb / '__params__').read_bytes())
    x = np.random.RandomState(2).randn(3, 13).astype(np.float32)
    for pred in (
            tinf.create_predictor(_cpu_config(str(d))),
            tinf.create_paddle_predictor(
                _cpu_config(str(comb / 'm.pdmodel')))):
        assert pred.get_input_names() == ['x']
        out, = pred.run([x])
        np.testing.assert_allclose(out, x @ w + b, rtol=1e-5, atol=1e-5)
    jout, = jinf.create_predictor(jinf.Config(str(d))).run([x])
    np.testing.assert_allclose(out, jout, rtol=1e-5, atol=1e-5)


def test_config_surface(tmp_path, monkeypatch):
    config = tinf.AnalysisConfig(str(tmp_path / 'm'))
    assert config.use_gpu() and config.gpu_device_id() == 0
    with pytest.raises(ValueError, match='paddle_tpu'):
        config.enable_tpu()
    if not torch.cuda.is_available():
        # the default is the card: no CPU is picked in its place
        with pytest.raises(RuntimeError, match='CUDA'):
            config.device()
    config.enable_use_gpu(device_id=1)
    assert config.gpu_device_id() == 1
    config.disable_gpu()
    assert not config.use_gpu() and config.device() == torch.device('cpu')
    assert 'torch.compile' in config.summary()
    # the optim cache directory is Inductor's
    monkeypatch.delenv('TORCHINDUCTOR_CACHE_DIR', raising=False)
    _, tm = _mlp_pair(8)
    tpt.jit.save(tm, str(tmp_path / 'm'))
    config.set_optim_cache_dir(str(tmp_path / 'cache'))
    tinf.create_predictor(config)
    assert os.environ['TORCHINDUCTOR_CACHE_DIR'] == str(tmp_path / 'cache')
    assert tinf.get_version() == tpt.__version__ == jinf.get_version()
    assert tinf.get_num_bytes_of_data_type(tinf.DataType.INT64) == 8
    assert tinf.PaddleInferTensor is tinf.Tensor
