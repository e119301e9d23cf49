"""The number format of the port's f32 flash kernels (csrc/tf32x3.cuh):
split TF32, emulated in numpy on the CPU.

The tensor cores take f32 operands only as TF32 (the low 13 mantissa bits
ignored). The f32 kernels at d = 64 and 128 (flash_fwd_tf32_kernel,
flash_bwd_kv_tf32_kernel, flash_bwd_dq_tf32_kernel) split each f32 operand
x into hi = x with those bits cleared and lo = x - hi, read as TF32 in turn,
and take a product a b as lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b). Here the
forward and the backward built from such products are held against a
float64 reference of the same f32 operands, and against the port's plain
versions and the JAX package's kernels; a single TF32 product is shown to
miss the 1e-4 that chip_smoke.py holds the f32 kernels to, which is why the
split exists. The kernels themselves run only on the card, where
chip_smoke.py holds them against their plain versions; the source checks
below keep the routing, the tensor maps and the entry names the wrappers
rely on."""
import os
import re
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch import _build
from paddle_tpu_torch.ops import flash_attention as tfa

CSRC = _build.CSRC
TF32_MASK = np.uint32(0xFFFFE000)
# chip_smoke.py's f32 tolerances (TOLERANCE, BWD_TOLERANCE)
CHIP_TOL = 1e-4
# the split's own error is f32 sum order and the dropped lo lo term, ~1e-6
SPLIT_TOL = 1e-5


def _tf32(x):
    """x as the tensor core reads it: the low 13 mantissa bits cleared."""
    return (np.ascontiguousarray(x, np.float32).view(np.uint32)
            & TF32_MASK).view(np.float32)


def _mm_split(a, b):
    """a @ b of f32 operands as three TF32 products summed in f32."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _mm_one(a, b):
    """a @ b as one TF32 product."""
    return _tf32(a) @ _tf32(b)


def _mm64(a, b):
    return a.astype(np.float64) @ b.astype(np.float64)


def _t(x):
    return np.swapaxes(x, -1, -2)


def _keep(n, m, causal):
    return np.tril(np.ones((n, m), bool)) if causal else np.ones((n, m), bool)


def _fwd(q, k, v, causal, scale, mm, dt):
    """The kernels' forward: masked scaled scores, softmax, o and lse."""
    s = mm(q, _t(k)).astype(dt) * dt(scale)
    s = np.where(_keep(*s.shape[-2:], causal), s, dt(-1e30))
    mx = s.max(-1, keepdims=True)
    p = np.exp(s - mx)
    l = p.sum(-1, keepdims=True)
    return mm(p, v).astype(dt) / l, mx + np.log(l)


def _bwd(q, k, v, do, lse, delta, causal, scale, mm, dt):
    """The kernels' backward: p = exp(min(s - lse, 30)), ds = p (dp -
    delta) scale, then dq = ds k, dk = ds^T q, dv = p^T do."""
    s = mm(q, _t(k)).astype(dt) * dt(scale)
    p = np.where(_keep(*s.shape[-2:], causal),
                 np.exp(np.minimum(s - lse, dt(30))), dt(0))
    ds = p * (mm(do, _t(v)).astype(dt) - delta) * dt(scale)
    return tuple(x.astype(dt) for x in (mm(ds, k), mm(_t(ds), q),
                                        mm(_t(p), do)))


def _inputs(n, d, seed):
    """chip_smoke.py's f32 inputs at a small size: randn q, k, do and
    0.5 randn v, b = 1, h = 2."""
    rng = np.random.RandomState(seed)
    q, k, do = (rng.randn(1, 2, n, d).astype(np.float32) for _ in range(3))
    v = (0.5 * rng.randn(1, 2, n, d)).astype(np.float32)
    return q, k, v, do


def _run(n, d, causal, mm):
    """(o, lse, (dq, dk, dv)) with products `mm` in f32, and the float64
    reference's, on the same inputs."""
    q, k, v, do = _inputs(n, d, seed=n + d + int(causal))
    scale = 1.0 / np.sqrt(d)
    o64, lse64 = _fwd(q, k, v, causal, scale, _mm64, np.float64)
    delta64 = (do.astype(np.float64) * o64).sum(-1, keepdims=True)
    g64 = _bwd(q, k, v, do, lse64, delta64, causal, scale, _mm64, np.float64)
    o, lse = _fwd(q, k, v, causal, scale, mm, np.float32)
    delta = (do * o).sum(-1, keepdims=True)
    g = _bwd(q, k, v, do, lse, delta, causal, scale, mm, np.float32)
    return (o, lse, g), (o64, lse64, g64)


def _errs(got, want):
    """(max |o err|, max |lse err|, each gradient's max error over its
    largest reference entry)."""
    (o, lse, g), (o64, lse64, g64) = got, want
    return (np.abs(o - o64).max(), np.abs(lse - lse64).max(),
            [np.abs(a - b).max() / np.abs(b).max() for a, b in zip(g, g64)])


CASES = [(n, d, causal) for n in (300, 512) for d in (64, 128)
         for causal in (True, False)]


@pytest.mark.parametrize('n, d, causal', CASES)
def test_split_tf32_keeps_the_f32_contract(n, d, causal):
    err_o, err_lse, grad = _errs(*_run(n, d, causal, _mm_split))
    assert err_o <= SPLIT_TOL and err_lse <= SPLIT_TOL
    assert max(grad) <= SPLIT_TOL, grad


@pytest.mark.parametrize('n, d, causal', CASES)
def test_one_tf32_product_misses_the_chip_tolerance(n, d, causal):
    # why the kernels take three products: one TF32 product leaves ~1e-3
    err_o, err_lse, grad = _errs(*_run(n, d, causal, _mm_one))
    assert max(err_o, err_lse) > CHIP_TOL
    assert max(grad) > CHIP_TOL


def test_hi_and_lo_are_tf32_words_that_sum_to_x():
    x = np.random.RandomState(0).randn(4096).astype(np.float32)
    hi = _tf32(x)
    lo = x - hi
    assert np.array_equal(hi + lo, x)  # the split itself is exact in f32
    assert not (hi.view(np.uint32) & ~TF32_MASK).any()
    # lo keeps the 13 bits hi dropped: |lo| < 2^-10 |x|
    assert (np.abs(lo) < 2.0 ** -10 * np.abs(x)).all()


@pytest.mark.parametrize('causal', [True, False])
def test_split_emulation_matches_plain_versions_and_pallas(causal,
                                                          monkeypatch):
    # the fused route's shape: the JAX package's _fwd_kernel and
    # _bwd_fused_kernel in the Pallas interpreter, the port's plain
    # versions, and the split emulation agree on one input
    monkeypatch.setenv('PADDLE_TPU_FLASH_INTERPRET', '1')
    monkeypatch.setenv('PADDLE_TPU_FLASH_STRICT', '1')
    n, d = 512, 64
    q, k, v, do = _inputs(n, d, seed=7)
    scale = 1.0 / np.sqrt(d)
    o, lse = _fwd(q, k, v, causal, scale, _mm_split, np.float32)
    delta = (do * o).sum(-1, keepdims=True)
    grads = _bwd(q, k, v, do, lse, delta, causal, scale, _mm_split,
                 np.float32)

    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o_t, lse_t = tfa.flash_attention_fwd_ref(tq, tk, tv, causal, scale)
    g_t = tfa.flash_attention_bwd_ref(tq, tk, tv, tdo, lse_t,
                                      (tdo * o_t).sum(-1, keepdim=True),
                                      causal, scale)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    o_j, lse_j = jfa._fwd_impl(jq, jk, jv, causal, scale)
    g_j = jfa._bwd_impl_fused(jq, jk, jv, lse_j, jdo,
                              jnp.sum(jdo * o_j, axis=-1, keepdims=True),
                              causal, scale)
    refs = {'torch plain versions': (o_t.numpy(), lse_t.numpy(),
                                     [g.numpy() for g in g_t]),
            'JAX interpret-mode kernels': (np.asarray(o_j),
                                           np.asarray(lse_j),
                                           [np.asarray(g) for g in g_j])}
    for ref, (want_o, want_lse, want_g) in refs.items():
        err = np.abs(o - want_o).max()
        assert err <= SPLIT_TOL, (ref, 'o', err)
        err = np.abs(lse - want_lse).max()
        assert err <= SPLIT_TOL, (ref, 'lse', err)
        for name, g, w in zip(('dq', 'dk', 'dv'), grads, want_g):
            err = np.abs(g - w).max()
            assert err <= SPLIT_TOL * np.abs(w).max(), \
                (ref, name, err, np.abs(w).max())


def _read(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _launch_d_case0(source):
    """The dtype 0 (f32) branch of launch_d in `source`."""
    text = _read(source)
    body = text[text.index('cudaError_t launch_d('):]
    return body[body.index('case 0:'):body.index('case 1:')]


@pytest.mark.parametrize('source', ['flash_fwd.cu', 'flash_bwd.cu'])
def test_f32_at_d64_and_d128_goes_to_the_split_tf32_kernels(source):
    case0 = ' '.join(_launch_d_case0(source).split())
    # the tensor-core head dims take launch_tf32; only d = 192 / 256 keep
    # the CUDA-core kernel
    assert 'if constexpr (WGMMA) return launch_tf32<D>' in case0
    assert 'else return launch_cc<float, D>' in case0
    assert re.search(r'constexpr bool WGMMA = D <= 128;',
                     _read(source)) is not None


@pytest.mark.parametrize('source, kernels', [
    ('flash_fwd.cu', ['flash_fwd_tf32_kernel']),
    ('flash_bwd.cu', ['flash_bwd_kv_tf32_kernel', 'flash_bwd_dq_tf32_kernel']),
])
def test_sources_hold_the_split_tf32_kernels(source, kernels):
    text = _read(source)
    assert '#include "tf32x3.cuh"' in text
    for name in kernels:
        assert re.search(r'__global__ void __launch_bounds__\(\w+, 1\)\s+%s\('
                         % name, text) is not None
    # their operands arrive through f32 tensor maps
    assert 'encode_rows_map<float>' in text


def test_split_tf32_header_holds_the_format():
    text = _read('tf32x3.cuh')
    assert 'mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32' in text
    assert 'TF32_MASK = 0xffffe000u' in text
    # the three terms, small ones first
    terms = re.findall(r'mma_tf32\(d, a\.(\w+), b\.(\w+)\)', text)
    assert terms == [('lo', 'hi'), ('hi', 'lo'), ('hi', 'hi')]


def test_tensor_maps_take_f32_tiles():
    text = _read('sm90_async.cuh')
    assert 'CU_TENSOR_MAP_DATA_TYPE_FLOAT32' in text
    assert 'std::is_same_v<T, float>' in text
    # a 128-byte swizzle box holds 32 f32 values
    assert 'return 128 / (int)sizeof(T);' in text


def test_every_backward_entry_keeps_its_c_name():
    # the wrappers bind these five names (ops/flash_attention.py:_bwd_lib);
    # tests/test_torch_flash_tma.py holds the entries' argument lists
    text = _read('flash_bwd.cu')
    for entry in ('flash_bwd_fused', 'flash_bwd_dq', 'flash_bwd_dkv',
                  'flash_bwd_dq_long', 'flash_bwd_dkv_long'):
        assert 'FLASH_BWD_ENTRY(%s,' % entry in text


def test_build_hash_covers_the_split_tf32_header(tmp_path, monkeypatch):
    for name in os.listdir(CSRC):
        if name.endswith(('.cu', '.cuh')):
            shutil.copy(os.path.join(CSRC, name), tmp_path)
    monkeypatch.setattr(_build, 'CSRC', str(tmp_path))
    before = [_build._target(n)[1] for n in ('flash_fwd', 'flash_bwd')]
    with open(tmp_path / 'tf32x3.cuh', 'a') as f:
        f.write('\n// edited\n')
    after = [_build._target(n)[1] for n in ('flash_fwd', 'flash_bwd')]
    assert all(a != b for a, b in zip(after, before))
