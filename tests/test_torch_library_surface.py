"""The rest of the port's library surface against the JAX package's:
F.sparse_attention (forward and gradients within 1e-5 of the JAX function
and jax.grad), framework.debug.check_numerics, utils, hub, sysconfig and
utils.op_benchmark (its configs' inputs bit for bit, their outputs, the
harness and the regression gate), all on the CPU at small sizes.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import functools
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.framework import debug as jdebug
from paddle_tpu.framework.core import Tensor as JTensor
from paddle_tpu.utils import op_benchmark as job

import paddle_tpu_torch as tpt
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.framework import debug as tdebug
from paddle_tpu_torch.framework import device as device_mod
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.utils import op_benchmark as tob

from test_torch_loss_functions import jax_fwd_grad

TOL = 1e-5
B, H, N, D, BLOCK = 2, 2, 16, 8, 4


def _csr(rng, n, block, nnz_pad=0):
    """A block layout as CSR over tokens: each query block attends to its
    own block and one random earlier one (BigBird-like), each row's
    columns ascending; `nnz_pad` unused trailing entries in the columns."""
    nb = n // block
    offs, cols = [0], []
    for i in range(n):
        qb = i // block
        blocks = sorted({qb, int(rng.randint(0, qb + 1))})
        row = [b * block + j for b in blocks for j in range(block)]
        cols += row
        offs.append(len(cols))
    assert nb > 1
    cols = cols + [0] * nnz_pad
    return (np.tile(np.asarray(offs, np.int32), (B, H, 1)),
            np.tile(np.asarray(cols, np.int32), (B, H, 1)))


def _case(name):
    """(offs, cols, key_padding_mask, attn_mask) of a named case."""
    rng = np.random.RandomState(7)
    offs, cols = _csr(rng, N, BLOCK)
    kpm = am = None
    if name in ('key_padding', 'both'):
        kpm = np.ones((B, N), np.float32)
        kpm[0, -5:] = 0
        kpm[1, :3] = 0
    if name in ('attn_mask', 'both'):
        am = (rng.uniform(size=(N, N)) > 0.3).astype(np.float32)
    if name == 'masked_row':
        # every key of row 5 masked: the row gives 0, not NaN
        am = np.ones((N, N), np.float32)
        am[5] = 0
    if name == 'short_nnz':
        offs, cols = _csr(rng, N, BLOCK, nnz_pad=6)
    return offs, cols, kpm, am


CASES = ['plain', 'key_padding', 'attn_mask', 'both', 'masked_row',
         'short_nnz']


@pytest.mark.parametrize('name', CASES)
def test_sparse_attention_matches_jax(name):
    offs, cols, kpm, am = _case(name)
    rng = np.random.RandomState(1)
    q, k, v = (rng.randn(B, H, N, D).astype(np.float32) for _ in range(3))

    def jfn(qq, kk, vv):
        return JF.sparse_attention(
            JTensor(qq), JTensor(kk), JTensor(vv), offs, cols,
            key_padding_mask=kpm, attn_mask=am)._data
    want, grads, cot = jax_fwd_grad(jfn, (q, k, v), seed=2)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    got = TF.sparse_attention(
        tq, tk, tv, torch.tensor(offs), torch.tensor(cols),
        key_padding_mask=None if kpm is None else torch.tensor(kpm),
        attn_mask=None if am is None else torch.tensor(am))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL,
                               atol=TOL)
    (got * torch.tensor(cot)).sum().backward()
    for t, g in zip((tq, tk, tv), grads):
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=TOL, atol=TOL)
    assert np.isfinite(got.detach().numpy()).all()
    if name == 'masked_row':
        assert not got[:, :, 5].any()
        assert not tq.grad[:, :, 5].any()


def test_sparse_attention_csr_mask_places_padding_as_jax():
    """The entries past nnz land on the last row, as jnp.repeat with
    total_repeat_length places them, and out-of-range columns drop."""
    from paddle_tpu_torch.nn.functional.sparse_attention import _csr_mask
    offs = np.array([0, 1, 1, 3, 3], np.int64)
    cols = np.array([2, 0, 3, 1, 1, 7, -1], np.int64)
    rows = np.asarray(jnp.repeat(jnp.arange(4), jnp.diff(jnp.asarray(offs)),
                                 total_repeat_length=len(cols)))
    want = np.asarray(jnp.zeros((4, 4), bool).at[rows, cols].set(True))
    got = _csr_mask(torch.tensor(offs), torch.tensor(cols), 4, 4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_check_numerics_matches_jax():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = torch.tensor(x)
    assert tdebug.check_numerics(t) is t
    bad = x.copy()
    bad[0, 1] = np.nan
    bad[1, 2] = np.inf
    bad[1, 0] = -np.inf
    with pytest.raises(FloatingPointError) as te:
        tdebug.check_numerics(torch.tensor(bad), name='act')
    with pytest.raises(FloatingPointError) as je:
        jdebug.check_numerics(paddle.to_tensor(bad), name='act')
    assert str(te.value) == str(je.value)
    assert '1 NaN and 2 Inf' in str(te.value)
    # numpy input too, and ints pass
    with pytest.raises(FloatingPointError, match='1 NaN'):
        tdebug.check_numerics(bad[:1])
    tdebug.check_numerics(torch.arange(4))


def test_check_nan_inf_flag_toggles_anomaly_detection():
    was = torch.is_anomaly_enabled()
    try:
        tdebug.enable_check_nan_inf()
        assert torch.is_anomaly_enabled()
        assert tpt.get_flags(['FLAGS_check_nan_inf'])[
            'FLAGS_check_nan_inf'] is True
        tdebug.disable_check_nan_inf()
        assert not torch.is_anomaly_enabled()
    finally:
        tpt.set_flags({'FLAGS_check_nan_inf': was})


def test_utils_match_jax(capsys):
    tu, ju = tpt.utils, paddle.utils
    assert sorted(tu.__all__) == sorted(ju.__all__)
    assert tu.try_import('json') is json
    for mod in (tu, ju):
        with pytest.raises(ImportError, match='no_such_module_x is required'):
            mod.try_import('no_such_module_x')
    assert tu.require_version('0.0.1') and tu.require_version('0.1.0',
                                                              '0.2')
    with pytest.raises(Exception, match='paddle_tpu_torch >= 9.0'):
        tu.require_version('9.0')
    with pytest.raises(RuntimeError) as te:
        tu.download('http://example.invalid/x')
    with pytest.raises(RuntimeError) as je:
        ju.download('http://example.invalid/x')
    assert str(te.value) == str(je.value)

    def f(a):
        return a + 1
    for mod in (tu, ju):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter('always')
            assert mod.deprecated('g', since='2.0', reason='old')(f)(1) == 2
        assert str(w[0].message) == \
            'f is deprecated since 2.0, use g instead. old'
    key = 'library_surface_test_key'
    assert tu.unique_name.generate(key) == key + '_0'
    assert tu.unique_name.generate(key) == key + '_1'
    opts = tu.ProfilerOptions({'state': 'GPU'})
    assert opts['state'] == 'GPU' and opts['batch_range'] == [10, 10]
    with pytest.raises(ValueError, match='named nope'):
        opts['nope']
    assert tu.get_profiler() is tpt.profiler
    assert tu.Profiler is tpt.profiler.Profiler
    assert tu.run_check('cpu') is True
    assert 'paddle_tpu_torch is installed successfully!' in \
        capsys.readouterr().out


def test_run_check_takes_the_current_device():
    saved = dict(device_mod._STATE)
    try:
        device_mod.set_device('cpu')
        assert tpt.utils.run_check()
    finally:
        device_mod._STATE.update(saved)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            tpt.utils.run_check('gpu')


HUBCONF = '''
"""A local hub repo."""
dependencies = []


def tiny(width=3):
    """A tiny model: a list of `width` zeros."""
    return [0.0] * width


def _private():
    return None
'''


def test_hub_local_repo_matches_jax(tmp_path):
    (tmp_path / 'hubconf.py').write_text(HUBCONF)
    repo = str(tmp_path)
    assert tpt.hub.list(repo) == paddle.hub.list(repo) == ['tiny']
    assert tpt.hub.help(repo, 'tiny') == paddle.hub.help(repo, 'tiny')
    assert tpt.hub.load(repo, 'tiny', width=2) == \
        paddle.hub.load(repo, 'tiny', width=2) == [0.0, 0.0]
    for fn, args in ((tpt.hub.list, (repo,)),
                     (tpt.hub.load, (repo, 'tiny'))):
        with pytest.raises(RuntimeError) as te:
            fn(*args, source='github')
        jfn = getattr(paddle.hub, fn.__name__)
        with pytest.raises(RuntimeError) as je:
            jfn(*args, source='github')
        assert str(te.value) == str(je.value)


def test_sysconfig():
    inc = tpt.sysconfig.get_include()
    assert os.path.isfile(os.path.join(inc, 'pd_extension.h'))
    assert inc.startswith(os.path.dirname(tpt.__file__))
    assert os.path.dirname(tpt.sysconfig.get_lib()) == \
        os.path.dirname(tpt.__file__)


# each default config at a small size (the same keyword arguments in both
# packages)
SMALL = {
    'matmul_1k_bf16': dict(m=32, k=16, n=8),
    'flash_attention_b4h12n512d64': dict(b=1, h=2, n=64, d=64),
    'sdpa_reference_b4h12n512d64': dict(b=1, h=2, n=64, d=64),
    'layernorm_16x512x768': dict(b=2, n=4, h=32),
    'softmax_ce_16x512_v30k': dict(b=2, n=4, v=50),
    'conv2d_32x64x56': dict(b=2, c=3, hw=8, co=4),
    'embedding_30k_768': dict(v=50, h=8, b=2, n=4),
}


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize('name', [n for n, _ in tob.OP_CONFIGS])
def test_op_configs_match_jax(name):
    assert [n for n, _ in tob.OP_CONFIGS] == [n for n, _ in job.OP_CONFIGS]
    tbuild = dict(tob.OP_CONFIGS)[name]
    jbuild = dict(job.OP_CONFIGS)[name]
    tfn, targs = tbuild(device='cpu', **SMALL[name])
    jfn, jargs = jbuild(**SMALL[name])
    assert len(targs) == len(jargs)
    for t, j in zip(targs, jargs):
        assert tuple(t.shape) == tuple(j.shape)
        # the same seeded inputs, bit for bit (ids as int64 here)
        np.testing.assert_array_equal(_f32(t), _f32(j))
    got = _f32(tfn(*targs))
    want = _f32(jax.jit(jfn)(*jargs))
    bf16 = any(t.dtype == torch.bfloat16 for t in targs)
    tol = 2e-2 if bf16 else TOL
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_flash_config_runs_the_plain_version_on_the_cpu():
    """The flash config on CPU tensors: the kernel's plain version,
    counted once a call, equal to the sdpa reference config's result."""
    kw = SMALL['flash_attention_b4h12n512d64']
    fn, args = tob._flash_attention(device='cpu', **kw)
    ref_fn, ref_args = tob._sdpa_ref(device='cpu', **kw)
    before = fa.counts['flash']
    res = tob.run_benchmarks([('flash_small', functools.partial(
        tob._flash_attention, **kw))], repeat=4, warmup=2, device='cpu')
    assert res[0]['ok'] and fa.counts['flash'] - before == 6
    np.testing.assert_allclose(fn(*args).float().numpy(),
                               ref_fn(*ref_args).float().numpy(),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_array_equal(
        fn(*args).float().numpy(),
        fa.flash_attention_fwd_ref(*args, True, 64 ** -0.5)[0].float()
        .numpy())


def test_op_benchmark_harness_and_gate():
    results = tob.run_benchmarks(
        configs=[('matmul_tiny', lambda device: tob._matmul(
            64, 64, 64, 'float32', device=device))],
        repeat=3, warmup=1, device='cpu')
    assert results[0]['ok'] and results[0]['mean_ms'] > 0
    base = [{'op': 'matmul_tiny', 'mean_ms': results[0]['mean_ms'] / 10,
             'ok': True}]
    regs = tob.compare(base, results, threshold=0.15)
    assert regs and regs[0]['op'] == 'matmul_tiny'
    assert tob.compare(results, results, threshold=0.15) == []
    # the gate is the JAX package's function
    assert regs == job.compare(base, results, threshold=0.15)
    # a failing config is reported, not raised
    bad = tob.run_benchmarks([('broken', lambda device: 1 / 0)],
                             device='cpu')
    assert bad == [{'op': 'broken', 'ok': False,
                    'error': "ZeroDivisionError('division by zero')"}]


def test_op_benchmark_main_writes_and_gates(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tob, 'OP_CONFIGS', [
        (name, functools.partial(build, **SMALL[name]))
        for name, build in tob.OP_CONFIGS if name != 'conv2d_32x64x56'])
    saved = dict(device_mod._STATE)
    try:
        device_mod.set_device('cpu')
        out = str(tmp_path / 'ops.json')
        assert tob.main(['--out', out, '--repeat', '2']) == 0
        with open(out) as f:
            rows = json.load(f)
        assert [r['op'] for r in rows] == [
            n for n, _ in tob.OP_CONFIGS]
        assert all(r['ok'] for r in rows)
        fast = str(tmp_path / 'fast.json')
        with open(fast, 'w') as f:
            json.dump([dict(r, mean_ms=r['mean_ms'] / 100) for r in rows], f)
        assert tob.main(['--baseline', fast, '--repeat', '2']) == 1
        assert 'PERF REGRESSIONS' in capsys.readouterr().out
        assert tob.main(['--baseline', out, '--threshold', '1e9',
                         '--repeat', '2']) == 0
    finally:
        device_mod._STATE.update(saved)
