"""The port's Go inference API (paddle_tpu_torch/capi/goapi) end to end:
tests/test_goapi.py on the port's shim and library.

Builds libpaddle_tpu_torch_c_<hash>.so, `go build`s the demo client
against it, runs it on a jit.save'd MLP on the CPU and compares the
printed outputs with the eager forward. Skips when the host has no Go
toolchain, as tests/test_goapi.py does; the static check that the shim
wraps every entry point of the header runs everywhere.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPI_DIR = os.path.join(REPO, 'paddle_tpu_torch', 'capi')
GOAPI_DIR = os.path.join(CAPI_DIR, 'goapi')


@pytest.fixture(scope='module')
def go_bin():
    path = shutil.which('go')
    if path is None:
        pytest.skip('go toolchain not installed')
    return path


@pytest.fixture(scope='module')
def capi_lib():
    from paddle_tpu_torch.capi import build_capi
    try:
        return build_capi()
    except RuntimeError as e:
        pytest.skip('capi build unavailable: %s' % e)


@pytest.fixture(scope='module')
def saved_model(tmp_path_factory):
    from paddle_tpu_torch.static import InputSpec
    tpt.seed(1234)
    model = tpt.nn.Sequential(tpt.nn.Linear(8, 16, device='cpu'),
                              tpt.nn.Tanh(),
                              tpt.nn.Linear(16, 4, device='cpu'))
    model.eval()
    path = str(tmp_path_factory.mktemp('goapi') / 'mlp')
    tpt.jit.save(model, path,
                 input_spec=[InputSpec([2, 8], name='features')])
    x = (0.125 * (np.arange(16, dtype=np.float32) - 8)).reshape(2, 8)
    with torch.no_grad():
        ref = model(torch.from_numpy(x)).numpy()
    return path, ref


@pytest.fixture(scope='module')
def demo_client(go_bin, capi_lib, tmp_path_factory):
    exe = str(tmp_path_factory.mktemp('gobuild') / 'demo_client')
    env = dict(os.environ)
    env['CGO_ENABLED'] = '1'
    env['CGO_CFLAGS'] = '-I' + CAPI_DIR
    env['CGO_LDFLAGS'] = ('-L%s -l:%s -Wl,-rpath,%s'
                          % (os.path.dirname(capi_lib),
                             os.path.basename(capi_lib),
                             os.path.dirname(capi_lib)))
    env.setdefault('GOFLAGS', '-mod=mod')
    env.setdefault('GOCACHE', str(tmp_path_factory.mktemp('gocache')))
    proc = subprocess.run([go_bin, 'build', '-o', exe, './cmd/demo'],
                          cwd=GOAPI_DIR, capture_output=True, text=True,
                          env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr
    return exe


def _env():
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        [p for p in sys.path if p and os.path.isdir(p)])
    return env


def test_go_client_matches_python_predictor(demo_client, saved_model):
    model_path, ref = saved_model
    proc = subprocess.run([demo_client, REPO, model_path, 'cpu'],
                          capture_output=True, text=True, env=_env(),
                          timeout=600)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    lines = proc.stdout.strip().splitlines()
    rank = int(lines[0].split()[1])
    dims = [int(l.split()[1]) for l in lines[1:1 + rank]]
    vals = np.array([float(l) for l in lines[1 + rank:]], np.float32)
    assert dims == list(ref.shape)
    np.testing.assert_allclose(vals.reshape(ref.shape), ref,
                               rtol=1e-5, atol=1e-6)


def test_go_client_reports_bad_model_path(demo_client, tmp_path):
    proc = subprocess.run([demo_client, REPO, str(tmp_path / 'nope'),
                           'cpu'],
                          capture_output=True, text=True, env=_env(),
                          timeout=600)
    # NewPredictor must fail through PD_GetLastError, not crash
    assert proc.returncode == 4, (proc.returncode, proc.stderr)
    assert proc.stderr.strip()


def test_go_sources_present_and_wrap_full_surface():
    """Static check (runs even without a Go toolchain): the shim wraps
    every PD_* entry point in the header, names the port's library and
    module, and the header matches the JAX package's entry points."""
    with open(os.path.join(CAPI_DIR, 'pd_capi.h')) as f:
        header = f.read()
    entries = set(re.findall(r'\b(PD_[A-Za-z]+)\s*\(', header))
    with open(os.path.join(REPO, 'paddle_tpu', 'capi', 'pd_capi.h')) as f:
        assert entries == set(re.findall(r'\b(PD_[A-Za-z]+)\s*\(',
                                         f.read()))
    with open(os.path.join(GOAPI_DIR, 'paddle.go')) as f:
        shim = f.read()
    missing = {e for e in entries if 'C.%s(' % e not in shim}
    assert not missing, 'goapi does not wrap: %s' % sorted(missing)
    assert 'libpaddle_tpu_torch_c' in shim
    with open(os.path.join(GOAPI_DIR, 'go.mod')) as f:
        module = f.read().split()[1]
    with open(os.path.join(GOAPI_DIR, 'cmd', 'demo', 'main.go')) as f:
        assert '"%s"' % module in f.read()
    with open(os.path.join(GOAPI_DIR, 'run_demo.sh')) as f:
        assert 'paddle_tpu_torch.capi import build_capi' in f.read()
    assert os.access(os.path.join(GOAPI_DIR, 'run_demo.sh'), os.X_OK)
