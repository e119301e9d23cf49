"""The port's C inference API (paddle_tpu_torch/capi) on the CPU, against
the JAX package's (paddle_tpu/capi).

The port's library (libpaddle_tpu_torch_c_<hash>.so, CPython embedded)
and a C client are built once a module with g++ / gcc; the client runs in
a subprocess against a jit.save'd MLP:
- tests/test_capi.py's three cases with device "cpu": outputs equal to
  the eager forward within 1e-5, calls before PD_Init fail cleanly, a bad
  model path fails PD_PredictorCreate through PD_GetLastError;
- the JAX package's library with tests/test_capi.py's own client, and the
  port's, serve the same MLP, each saved by its own package's jit.save:
  their outputs agree within 1e-5;
- "tpu", an unknown device string, and "gpu" on a host without CUDA fail
  PD_PredictorCreate cleanly (no fallback to the CPU).

The children share one Inductor cache directory, so the Predictor's CPU
compile is paid once.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as tpt
from paddle_tpu_torch import capi

import test_capi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_capi.py's client with the device from argv[3]
CLIENT_C = test_capi.CLIENT_C.replace(
    '/* argv: repo_root model_dir [--no-init] */',
    '/* argv: repo_root model_dir [device | --no-init] */').replace(
    'if (argc > 3) {', 'if (argc > 3 && argv[3][0] == \'-\') {').replace(
    'PD_ConfigSetDevice(cfg, "cpu");',
    'PD_ConfigSetDevice(cfg, argc > 3 ? argv[3] : "cpu");')


def _build_client(lib, header, source, exe):
    src = exe + '.c'
    with open(src, 'w') as f:
        f.write(source)
    cmd = ['gcc', '-O1', '-o', exe, src, '-I', os.path.dirname(header), lib,
           '-Wl,-rpath,' + os.path.dirname(lib)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return exe


@pytest.fixture(scope='module')
def client(tmp_path_factory):
    lib = capi.build_capi()
    assert os.path.basename(lib).startswith('libpaddle_tpu_torch_c_')
    assert capi.build_capi() == lib  # built once, then reused
    return _build_client(lib, capi.header_path(), CLIENT_C, str(
        tmp_path_factory.mktemp('capi') / 'client'))


@pytest.fixture(scope='module')
def env(tmp_path_factory):
    env = dict(os.environ)
    # the embedded interpreter must resolve the venv's packages AND the
    # repo; the C side only prepends the repo root
    env['PYTHONPATH'] = os.pathsep.join(
        [p for p in sys.path if p and os.path.isdir(p)])
    env.pop('XLA_FLAGS', None)  # no virtual-device mesh inside a client
    env['TORCHINDUCTOR_CACHE_DIR'] = str(tmp_path_factory.mktemp('inductor'))
    return env


X = (0.125 * (np.arange(16, dtype=np.float32) - 8)).reshape(2, 8)


@pytest.fixture(scope='module')
def saved_models(tmp_path_factory):
    """The MLP of tests/test_capi.py, built in JAX and carried to the
    port; each package's jit.save writes its own artifact."""
    from paddle_tpu.static import InputSpec as JSpec
    from paddle_tpu_torch.static import InputSpec as TSpec
    paddle.seed(1234)
    jm = paddle.nn.Sequential(paddle.nn.Linear(8, 16), paddle.nn.Tanh(),
                              paddle.nn.Linear(16, 4))
    jm.eval()
    tm = tpt.nn.Sequential(tpt.nn.Linear(8, 16, device='cpu'),
                           tpt.nn.Tanh(), tpt.nn.Linear(16, 4, device='cpu'))
    tm.load_state_dict({k: torch.from_numpy(np.array(v.numpy()))
                        for k, v in jm.state_dict().items()})
    tm.eval()
    root = tmp_path_factory.mktemp('capi_models')
    jpath, tpath = str(root / 'jax_mlp'), str(root / 'torch_mlp')
    paddle.jit.save(jm, jpath, input_spec=[JSpec([2, 8], name='features')])
    tpt.jit.save(tm, tpath, input_spec=[TSpec([2, 8], name='features')])
    with torch.no_grad():
        ref = tm(torch.from_numpy(X)).numpy()
    return jpath, tpath, ref


def _parse(stdout):
    lines = stdout.strip().splitlines()
    rank = int(lines[0].split()[1])
    dims = [int(l.split()[1]) for l in lines[1:1 + rank]]
    vals = np.array([float(l) for l in lines[1 + rank:]], np.float32)
    return vals.reshape(dims)


def _run(exe, env, *args, timeout=600):
    return subprocess.run([exe, REPO] + list(args), capture_output=True,
                          text=True, env=env, timeout=timeout)


@pytest.fixture(scope='module')
def port_outputs(client, env, saved_models):
    proc = _run(client, env, saved_models[1], 'cpu')
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    return _parse(proc.stdout)


def test_c_client_matches_python_predictor(port_outputs, saved_models):
    ref = saved_models[2]
    assert port_outputs.shape == ref.shape
    np.testing.assert_allclose(port_outputs, ref, rtol=1e-5, atol=1e-6)


def test_c_client_pre_init_fails_cleanly(client):
    proc = subprocess.run([client, REPO, 'ignored', '--no-init'],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, (proc.returncode, proc.stderr)
    assert 'PD_Init has not been called' in proc.stderr


def test_c_client_reports_bad_model_path(client, env, tmp_path):
    proc = _run(client, env, str(tmp_path / 'nope'), 'cpu')
    # create must fail cleanly through PD_GetLastError, not crash
    assert proc.returncode == 4, (proc.returncode, proc.stderr)
    assert 'create:' in proc.stderr


def test_jax_and_port_c_clients_agree(port_outputs, env, saved_models,
                                      tmp_path):
    from paddle_tpu.capi import build_capi as jax_build, header_path
    jlib = jax_build()
    assert os.path.basename(jlib).startswith('libpaddle_tpu_c_')
    jexe = _build_client(jlib, header_path(), test_capi.CLIENT_C,
                         str(tmp_path / 'jax_client'))
    proc = _run(jexe, env, saved_models[0])
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    jax_outputs = _parse(proc.stdout)
    assert jax_outputs.shape == port_outputs.shape
    np.testing.assert_allclose(port_outputs, jax_outputs, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize('device,message', [
    ('tpu', 'enable_tpu: paddle_tpu_torch runs on CUDA GPUs and the CPU'),
    ('npu', "device 'npu': the C API serves on 'gpu' or 'cpu'"),
    ('gpu', 'CUDA is not available')])
def test_device_refusals_fail_create_cleanly(client, env, saved_models,
                                             device, message):
    if device == 'gpu' and torch.cuda.is_available():
        pytest.skip('a card is present: "gpu" serves')
    proc = _run(client, env, saved_models[1], device)
    assert proc.returncode == 4, (proc.returncode, proc.stderr)
    assert 'create: create: ' in proc.stderr and message in proc.stderr
