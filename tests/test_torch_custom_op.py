"""The port's C++ custom ops (paddle_tpu_torch/utils/cpp_extension)
against the JAX package's: the same C++ sources built by both loaders
with g++, each against its package's pd_extension.h, and run on the same
inputs. Outputs and gradients must be equal exactly (the kernels are the
same host code). The counterparts of tests/test_custom_op.py, plus a
two-output op with a grad kernel and the ops under
torch.compile(fullgraph=True).

The JAX loader's libraries share one op registry in a process (g++ makes
the header's registry one symbol process-wide), so a library loaded by
the JAX loader here would show its ops in every later JAX load of this
process (tests/test_custom_op.py's included), and theirs in ours. The JAX
side therefore runs in a subprocess of its own (`jax_side`), once a
module; the port's libraries keep their own registries.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import json
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from paddle_tpu.utils import cpp_extension as jext

import paddle_tpu_torch as tpt
from paddle_tpu_torch.utils import cpp_extension as text

from test_custom_op import RELU_SRC

PAIR_SRC = textwrap.dedent('''
#include "pd_extension.h"

static int pair_fwd(const PDTensor* ins, int n_in, PDTensor* outs,
                    int n_out) {
  const float* x = (const float*)ins[0].data;
  float* a = (float*)outs[0].data;
  float* b = (float*)outs[1].data;
  for (int64_t i = 0; i < pd_numel(&ins[0]); i++) {
    a[i] = 2.f * x[i];
    b[i] = x[i] * x[i];
  }
  return 0;
}

static int pair_bwd(const PDTensor* ins, int n_in, PDTensor* outs,
                    int n_out) {
  const float* x = (const float*)ins[0].data;
  const float* da = (const float*)ins[1].data;
  const float* db = (const float*)ins[2].data;
  float* dx = (float*)outs[0].data;
  for (int64_t i = 0; i < pd_numel(&ins[0]); i++)
    dx[i] = 2.f * da[i] + 2.f * x[i] * db[i];
  return 0;
}

PD_BUILD_OP(custom_pair, 1, 2, pair_fwd);
PD_BUILD_GRAD_OP(custom_pair, 3, 1, pair_bwd);
''')


SQUARE_SRC = textwrap.dedent('''
#include "pd_extension.h"
static int sq(const PDTensor* ins, int n, PDTensor* outs, int m) {
  const float* x = (const float*)ins[0].data;
  float* y = (float*)outs[0].data;
  for (int64_t i = 0; i < pd_numel(&ins[0]); i++) y[i] = x[i] * x[i];
  return 0;
}
PD_BUILD_OP(custom_square, 1, 1, sq);
''')

BAD_SRC = textwrap.dedent('''
#include "pd_extension.h"
static int f(const PDTensor* ins, int n, PDTensor* outs, int m) {
  return 0;
}
PD_BUILD_OP(custom_bad, 1, 1, f);
PD_BUILD_GRAD_OP(custom_bad, 3, 1, f);  // wrong: should be 2 inputs
''')

X = np.random.RandomState(0).standard_normal((4, 5)).astype(np.float32)
COT = np.random.RandomState(1).standard_normal(X.shape).astype(np.float32)
JIT_X = np.asarray([[-1.0, 2.0], [0.5, -3.0]], np.float32)
CAT_A, CAT_B = (np.random.RandomState(2).standard_normal(
    (3, 6)).astype(np.float32)[:, :2].copy(),
    np.random.RandomState(2).standard_normal((3, 4)).astype(np.float32))
PAIR_X, PAIR_C1, PAIR_C2 = np.random.RandomState(3).standard_normal(
    (3, 2, 3)).astype(np.float32)
SQUARE_X = np.asarray([2.0, 3.0], np.float32)
INPUTS = dict(x=X, cot=COT, jit_x=JIT_X, cat_a=CAT_A, cat_b=CAT_B,
              pair_x=PAIR_X, pair_c1=PAIR_C1, pair_c2=PAIR_C2,
              square_x=SQUARE_X)

# the JAX side: every source through the JAX loader, in a fresh interpreter
JAX_SIDE = '''
import json, sys
import jax, jax.numpy as jnp
import numpy as np
import paddle_tpu as paddle
from paddle_tpu.utils.cpp_extension import load
d = sys.argv[1]
a = dict(np.load(sys.argv[2]))
T = paddle.to_tensor
out = {}
ext = load('custom_ops', [d + '/custom_ops.cc'], build_directory=d + '/jax')
out['op_names'] = ext.op_names()
out['relu'] = ext.custom_relu(T(a['x'])).numpy().tolist()
x = T(a['x'], stop_gradient=False)
(ext.custom_relu(x) * T(a['cot'])).sum().backward()
out['relu_grad'] = x.grad.numpy().tolist()
fn = ext._ops['custom_relu']._fn
out['jit'] = np.asarray(jax.jit(lambda v: fn(v) * 2.0)(a['jit_x'])).tolist()
out['jit_grad'] = np.asarray(jax.grad(
    lambda v: jnp.sum(fn(v) * v))(a['jit_x'])).tolist()
out['cat'] = ext.custom_cat2(T(a['cat_a']), T(a['cat_b'])).numpy().tolist()
pair = load('pair_ops', [d + '/pair_ops.cc'], build_directory=d + '/jax')
x = T(a['pair_x'], stop_gradient=False)
p, q = pair.custom_pair(x)
(p * T(a['pair_c1']) + q * T(a['pair_c2'])).sum().backward()
out['pair'] = [p.numpy().tolist(), q.numpy().tolist(),
               x.grad.numpy().tolist()]
sq = load('sq_ext', [d + '/sq.cc'], build_directory=d + '/jax')
y = sq.custom_square(T(a['square_x'], stop_gradient=False))
out['square'] = y.numpy().tolist()
try:
    y.sum().backward()
    out['square_backward'] = 'ran'
except Exception as e:
    out['square_backward'] = type(e).__name__
try:
    load('bad_ext', [d + '/bad.cc'], build_directory=d + '/jax')
    out['bad'] = None
except RuntimeError as e:
    out['bad'] = str(e)
print(json.dumps(out))
'''


@pytest.fixture(scope='module')
def sources(tmp_path_factory):
    d = tmp_path_factory.mktemp('custom_op_src')
    for name, src in (('custom_ops', RELU_SRC), ('pair_ops', PAIR_SRC),
                      ('sq', SQUARE_SRC), ('bad', BAD_SRC)):
        (d / (name + '.cc')).write_text(src)
    return d


@pytest.fixture(scope='module')
def jax_side(sources):
    arrays = str(sources / 'inputs.npz')
    np.savez(arrays, **INPUTS)
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    res = subprocess.run([sys.executable, '-c', JAX_SIDE, str(sources),
                          arrays], capture_output=True, text=True,
                         timeout=300, env=env,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    return {k: np.asarray(v, np.float32) if isinstance(v, list) and
            k != 'op_names' else v for k, v in out.items()}


def _port(sources, name, tag):
    return text.load(tag, [str(sources / (name + '.cc'))],
                     build_directory=str(sources / 'torch'))


@pytest.fixture(scope='module')
def ext(sources):
    return _port(sources, 'custom_ops', 'custom_ops')


def test_custom_relu_forward_matches_jax(ext, jax_side):
    got = ext.custom_relu(torch.tensor(X))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), jax_side['relu'])
    np.testing.assert_array_equal(got.numpy(), np.maximum(X, 0))
    assert ext.custom_relu.host_round_trips == 0  # CPU tensors go directly


def test_custom_relu_backward_matches_jax(ext, jax_side):
    tx = torch.tensor(X, requires_grad=True)
    (ext.custom_relu(tx) * torch.tensor(COT)).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), jax_side['relu_grad'])


def test_custom_op_under_compile_matches_jax_jit(ext, jax_side):
    torch._dynamo.reset()
    tf = torch.compile(lambda x: ext.custom_relu(x) * 2.0, fullgraph=True)
    np.testing.assert_array_equal(tf(torch.tensor(JIT_X)).numpy(),
                                  jax_side['jit'])
    tx = torch.tensor(JIT_X, requires_grad=True)
    tg = torch.compile(lambda x: (ext.custom_relu(x) * x).sum(),
                       fullgraph=True)
    tg(tx).backward()
    np.testing.assert_array_equal(tx.grad.numpy(), jax_side['jit_grad'])


def test_custom_infer_shape_op_matches_jax(ext, jax_side):
    got = ext.custom_cat2(torch.tensor(CAT_A), torch.tensor(CAT_B))
    assert tuple(got.shape) == (3, 6)
    np.testing.assert_array_equal(got.numpy(), jax_side['cat'])
    torch._dynamo.reset()
    compiled = torch.compile(lambda x, y: ext.custom_cat2(x, y) + 1.0,
                             fullgraph=True)
    np.testing.assert_array_equal(
        compiled(torch.tensor(CAT_A), torch.tensor(CAT_B)).numpy(),
        jax_side['cat'] + 1.0)


def test_two_output_op_and_its_grad_match_jax(sources, jax_side):
    t = _port(sources, 'pair_ops', 'pair_ops')
    tx = torch.tensor(PAIR_X, requires_grad=True)
    ta, tb = t.custom_pair(tx)
    (ta * torch.tensor(PAIR_C1) + tb * torch.tensor(PAIR_C2)).sum().backward()
    ja, jb, jgrad = jax_side['pair']
    np.testing.assert_array_equal(ta.detach().numpy(), ja)
    np.testing.assert_array_equal(tb.detach().numpy(), jb)
    np.testing.assert_array_equal(tx.grad.numpy(), jgrad)
    # the grad kernel under compile too
    torch._dynamo.reset()
    tx2 = torch.tensor(PAIR_X, requires_grad=True)

    def loss(x):
        a, b = t.custom_pair(x)
        return (a * torch.tensor(PAIR_C1) + b * torch.tensor(PAIR_C2)).sum()
    torch.compile(loss, fullgraph=True)(tx2).backward()
    np.testing.assert_array_equal(tx2.grad.numpy(), jgrad)


def test_libraries_keep_their_own_ops(sources, jax_side):
    """Each port library lists its own ops, whatever was loaded before
    it (unlike the JAX loader's libraries; see the module docstring)."""
    assert _port(sources, 'custom_ops', 'custom_ops').op_names() == \
        jax_side['op_names'] == ['custom_cat2', 'custom_relu']
    assert _port(sources, 'pair_ops', 'pair_ops').op_names() == \
        ['custom_pair']
    assert _port(sources, 'sq', 'sq_ext').op_names() == ['custom_square']


def test_load_cache_and_input_validation(ext, tmp_path):
    t = ext
    with pytest.raises(ValueError, match='expects 1 inputs, got 2'):
        t.custom_relu(torch.ones(2), torch.ones(2))
    with pytest.raises(TypeError, match='float32, float64, int32'):
        t.custom_relu(torch.ones(2, dtype=torch.float16))
    # numpy arrays are taken as they are, as the JAX op takes them
    np.testing.assert_array_equal(t.custom_relu(X).numpy(),
                                  np.maximum(X, 0))
    # the same source and flags: the cached library, the same module
    src = tmp_path / 'custom_ops.cc'
    src.write_text(RELU_SRC)
    a = text.load('c', [str(src)], build_directory=str(tmp_path))
    so = [f for f in os.listdir(tmp_path) if f.endswith('.so')]
    assert text.load('c', [str(src)], build_directory=str(tmp_path)) is a
    assert [f for f in os.listdir(tmp_path) if f.endswith('.so')] == so
    # other flags: another library, and another torch op namespace
    b = text.load('c', [str(src)], build_directory=str(tmp_path),
                  extra_cflags=['-O1'])
    assert b is not a and len(os.listdir(tmp_path)) == 3
    np.testing.assert_array_equal(b.custom_relu(torch.tensor(X)).numpy(),
                                  a.custom_relu(torch.tensor(X)).numpy())


def test_gradless_op_forward_ok_backward_errors(sources, jax_side):
    # an op without a grad kernel must still run FORWARD on inputs that
    # require grad; the error fires only when a gradient is pulled
    t = _port(sources, 'sq', 'sq_ext')
    ty = t.custom_square(torch.tensor(SQUARE_X, requires_grad=True))
    np.testing.assert_array_equal(ty.detach().numpy(),
                                  np.asarray(jax_side['square'], np.float32))
    with pytest.raises(NotImplementedError, match='no grad kernel'):
        ty.sum().backward()
    assert jax_side['square_backward'] != 'ran'


def test_bad_grad_arity_rejected_as_jax(sources, jax_side):
    with pytest.raises(RuntimeError, match='grad kernel') as te:
        _port(sources, 'bad', 'bad_ext')
    assert str(te.value) == jax_side['bad']


def _code(path):
    """A header's code: its comments and blank lines dropped."""
    with open(path) as f:
        body = re.sub(r'//[^\n]*', '', f.read())
    return [line.rstrip() for line in body.splitlines() if line.strip()]


def test_header_abi_is_the_jax_packages():
    """One C++ source builds against either package: the port's header
    is the JAX package's but for its comments; sysconfig points at it."""
    theader = os.path.join(text.get_include_dir(), 'pd_extension.h')
    jheader = os.path.join(jext.get_include_dir(), 'pd_extension.h')
    assert _code(theader) == _code(jheader)
    assert tpt.sysconfig.get_include() == text.get_include_dir()
    assert os.path.isfile(os.path.join(tpt.sysconfig.get_include(),
                                       'pd_extension.h'))
    assert text.CUDAExtension is text.CppExtension
    assert sorted(text.__all__) == sorted(jext.__all__)


def test_setup_builds_each_extension(tmp_path):
    src = tmp_path / 'ops.cc'
    src.write_text(RELU_SRC)
    ext = text.CUDAExtension([str(src)], build_directory=str(tmp_path),
                             extra_cuda_cflags=['-O3'])
    (so,) = text.setup('setup_ops', ext_modules=[ext],
                       cmdclass={'build_ext': text.BuildExtension})
    assert so.startswith(str(tmp_path)) and os.path.isfile(so)
    mod = text.load_op_library(so)
    np.testing.assert_array_equal(mod.custom_relu(torch.tensor(X)).numpy(),
                                  np.maximum(X, 0))
