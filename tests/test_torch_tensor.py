"""The port's tensor functions (paddle_tpu_torch/tensor/), activations
(nn.functional.activation and the activation layers), containers and
top-level names against the JAX package's.

One table holds the deterministic functions: the same seeded numpy inputs,
float and integer, go through `paddle_tpu.<name>` and the port's
function, and the results must agree within the case's tolerance and in
kind (bool, signed or unsigned integer, float). Widths may differ: the JAX
package runs with x64 off, so its int64 is int32, where the port keeps
int64. The random functions are held to their distributions (JAX's
threefry bits cannot be reproduced) and to reproducibility under an
explicit generator."""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as tpt
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.framework import device as device_mod
from paddle_tpu_torch.nn import functional as TF

RNG = np.random.RandomState(0)
X = RNG.randn(3, 4).astype(np.float32)
Y = RNG.randn(3, 4).astype(np.float32)
P = (RNG.rand(3, 4) + 0.5).astype(np.float32)          # positive
U = (RNG.rand(3, 4) * 1.8 - 0.9).astype(np.float32)    # in (-1, 1)
XI = RNG.randint(-5, 6, (3, 4)).astype(np.int64)
YI = RNG.randint(1, 6, (3, 4)).astype(np.int64)         # positive
B = RNG.rand(3, 4) > 0.5
V = RNG.randn(4).astype(np.float32)
M3 = RNG.randn(2, 3, 3).astype(np.float32)
SQ = (RNG.randn(3, 3) + 3 * np.eye(3)).astype(np.float32)
SPD = (SQ @ SQ.T + np.eye(3)).astype(np.float32)
T3 = RNG.randn(2, 3, 4).astype(np.float32)
IDX = np.array([2, 0, 1], np.int64)
SORTED = np.sort(RNG.randn(6)).astype(np.float32)
EVEN = RNG.randn(3, 6).astype(np.float32)
RAGGED = np.array([3, 1, 3, 3, 2, 1, 1], np.int64)
C3 = RNG.randn(4, 3).astype(np.float32)

TOL = (1e-5, 1e-6)
LOOSE = (1e-4, 1e-5)


def C(name, *args, tol=TOL, fn=None, **kw):
    """A case: `name` in both packages (or fn(module) picking the function
    from paddle_tpu / paddle_tpu_torch.tensor), called on args."""
    _IDS[name] = _IDS.get(name, -1) + 1
    return pytest.param(name, fn, args, kw, tol,
                        id='%s-%d' % (name, _IDS[name]))


_IDS = {}
act = dict(fn=lambda mod, name: getattr(JF if mod is paddle else TF, name))

CASES = [
    # -- elementwise unary, float and integer inputs --------------------
    *[C(n, X) for n in ('exp', 'expm1', 'square', 'abs', 'sign', 'neg',
                        'sin', 'cos', 'tan', 'atan', 'sinh', 'cosh', 'tanh',
                        'asinh', 'erf', 'floor', 'ceil', 'round', 'trunc',
                        'frac', 'sigmoid', 'rad2deg', 'deg2rad', 'isfinite',
                        'isnan', 'isinf', 'stanh')],
    *[C(n, P) for n in ('log', 'log2', 'log10', 'log1p', 'sqrt', 'rsqrt',
                        'reciprocal')],
    *[C(n, P, tol=LOOSE) for n in ('digamma', 'lgamma', 'i0')],
    *[C(n, U) for n in ('asin', 'acos', 'atanh')],
    C('erfinv', U, tol=LOOSE),
    C('acosh', P + 1),
    *[C(n, XI) for n in ('exp', 'abs', 'sign', 'neg', 'square', 'floor',
                         'ceil', 'round', 'trunc', 'sin', 'erf')],
    *[C(n, YI) for n in ('sqrt', 'log', 'reciprocal')],
    # -- elementwise binary ---------------------------------------------
    *[C(n, X, Y) for n in ('add', 'subtract', 'multiply', 'divide',
                           'floor_divide', 'mod', 'remainder', 'floor_mod',
                           'maximum', 'minimum', 'fmax', 'fmin', 'atan2',
                           'hypot', 'logaddexp', 'copysign', 'heaviside',
                           'elementwise_add', 'elementwise_div')],
    C('pow', P, Y), C('outer', V, V), C('kron', SQ, SQ), C('inner', V, V),
    *[C(n, XI, YI) for n in ('add', 'subtract', 'multiply', 'divide',
                             'floor_divide', 'mod', 'maximum', 'minimum',
                             'gcd', 'lcm', 'pow', 'atan2')],
    # Python scalars take the tensor's dtype (the JAX package's rule)
    C('add', X, 2.5), C('add', XI, 2.5), C('multiply', XI, 3),
    C('divide', XI, 2), C('subtract', 2.0, X), C('pow', XI, 2),
    C('maximum', X, 0.0), C('multiply', X.astype(np.float16), 1.1),
    C('scale', X, 2.0, 0.5), C('scale', X, 2.0, 0.5, False),
    C('clip', X, -0.5, 0.5), C('clip', XI, -2, 3), C('lerp', X, Y, 0.3),
    C('nan_to_num', np.array([np.nan, np.inf, -np.inf, 1.0], np.float32)),
    C('take', X, IDX), C('take', X, np.array([13, -14]), mode='wrap'),
    C('take', X, np.array([20, -3]), mode='clip'),
    C('multiplex', [X, Y], np.array([[1], [0], [1]])),
    C('add_n', [X, Y, P]),
    # -- reductions -----------------------------------------------------
    *[C(n, X, axis=ax, keepdim=kd) for n in ('sum', 'mean', 'max', 'min',
                                             'amax', 'amin', 'prod',
                                             'logsumexp', 'nansum',
                                             'nanmean')
      for ax, kd in ((None, False), (1, False), ([0, 1], True), (0, True))],
    *[C(n, XI, axis=ax) for n in ('sum', 'mean', 'max', 'prod',
                                  'count_nonzero')
      for ax in (None, 1)],
    *[C(n, B, axis=ax) for n in ('all', 'any', 'sum') for ax in (None, 0)],
    C('sum', X, dtype='float64'),
    C('cumsum', X, 1), C('cumsum', XI), C('cumsum', B), C('cumprod', P, 1),
    C('cummax', X, 1), C('cummin', X, 0), C('cummax', XI),
    C('cummin', RAGGED),
    C('diff', X), C('diff', X, 2, 0),
    C('diff', X, prepend=Y[:, :1], append=Y[:, 1:2]),
    C('trace', SQ), C('trace', T3, 1, 1, 2), C('diagonal', T3, 0, 1, 2),
    # -- creation -------------------------------------------------------
    C('zeros', [2, 3]), C('ones', [2], dtype='int32'),
    C('full', [2, 2], 1.5), C('zeros_like', XI), C('ones_like', X, 'int64'),
    C('full_like', X, 7), C('arange', 5), C('arange', 1.0, 3.0, 0.5),
    C('arange', 2, 11, 3), C('linspace', 0.0, 1.0, 5),
    C('logspace', 0.0, 2.0, 3), C('eye', 3), C('eye', 2, 4, dtype='int64'),
    C('diag', V), C('diag', SQ), C('diag', V, 1), C('diag', V, 0, 9.0),
    C('diagflat', SQ), C('tril', X), C('triu', X, 1), C('tril', X, -1),
    C('tril_indices', 4, 3, 1), C('triu_indices', 3, None, -1),
    C('meshgrid', V[:2], V), C('numel', T3), C('clone', X),
    C('assign', X), C('complex', X, Y),
    # -- manipulation ---------------------------------------------------
    C('reshape', T3, [4, -1]), C('transpose', T3, [2, 0, 1]),
    C('concat', [X, Y], 1), C('concat', [XI, YI]), C('stack', [X, Y], 1),
    C('unstack', T3, 1), C('split', T3, 2, 2), C('split', T3, [1, -1], 1),
    C('chunk', T3, 3, 1), C('unbind', T3, 2),
    C('squeeze', X[None, :, None]), C('squeeze', X[None, :, None], [0, 1]),
    C('unsqueeze', X, [0, 2]), C('flatten', T3), C('flatten', T3, 1),
    C('gather', X, IDX), C('gather', X, IDX[:2], 1),
    C('gather_nd', T3, np.array([[0, 1], [1, 2]])),
    C('scatter', X, IDX[:2], Y[:2]),
    C('scatter', X, np.array([1, 1]), Y[:2], False),
    C('scatter_nd_add', X, np.array([[0], [2], [0]]), Y),
    C('scatter_nd', np.array([[1], [3]]), V[:2], [5]),
    C('tile', X, [2, 1]), C('expand', V, [3, 4]), C('expand', V, [2, -1]),
    C('expand_as', V, X), C('broadcast_to', V, [3, 4]),
    C('broadcast_tensors', [V, X]), C('flip', X, 1), C('flip', X, [0, 1]),
    C('rot90', X), C('rot90', X, 2), C('roll', X, 1), C('roll', X, [1, 2],
                                                          [0, 1]),
    C('cast', X, 'int32'), C('cast', XI, 'float32'), C('cast', X, 'bool'),
    C('slice', T3, [1, 2], [0, 1], [2, 3]),
    C('strided_slice', T3, [2], [3], [0], [-1]),
    C('strided_slice', T3, [1, 2], [0, 0], [3, 4], [2, 2]),
    C('unique', RAGGED), C('unique', RAGGED, True, True, True),
    C('unique_consecutive', RAGGED, True, True),
    C('masked_select', X, B), C('index_select', X, IDX[:2], 1),
    C('index_sample', X, np.array([[0, 1], [3, 3], [2, 0]])),
    C('take_along_axis', X, np.argsort(X, 1), 1),
    C('put_along_axis', X, np.array([[0], [1], [3]]), 9.0, 1),
    C('put_along_axis', X, np.array([[0], [1], [3]]), Y[:, :1], 1, 'add'),
    C('put_along_axis', X, np.array([[0], [1], [3]]), 2.0, 1, 'multiply'),
    C('tensordot', T3, C3, 1), C('tensordot', X, Y, [[0, 1], [0, 1]]),
    C('moveaxis', T3, 0, 2), C('repeat_interleave', X, 2, 1),
    C('repeat_interleave', V, np.array([1, 0, 2, 1]), 0),
    C('crop', T3, [1, 2, -1], [1, 1, 1]), C('atleast_2d', V),
    C('atleast_3d', X), C('atleast_1d', np.float32(3.0)),
    C('shard_index', np.array([[1], [6], [12], [-1], [20]]), 20, 2, 1),
    C('as_real', (X + 1j * Y).astype(np.complex64)),
    C('as_complex', T3[..., :2].copy()),
    # -- logic ----------------------------------------------------------
    *[C(n, X, Y) for n in ('equal', 'not_equal', 'less_than', 'less_equal',
                           'greater_than', 'greater_equal', 'allclose',
                           'isclose', 'equal_all')],
    C('equal', XI, 3), C('greater_than', X, 0.0),
    *[C(n, B, ~B) for n in ('logical_and', 'logical_or', 'logical_xor')],
    *[C(n, XI, YI) for n in ('bitwise_and', 'bitwise_or', 'bitwise_xor')],
    C('logical_not', B), C('bitwise_not', XI), C('is_empty', X),
    C('isclose', X, X + 1e-7), C('equal_all', X, X),
    # -- search ---------------------------------------------------------
    C('argmax', X), C('argmax', X, 1), C('argmin', X, 0, True),
    C('argmax', XI, keepdim=True), C('argsort', X), C('argsort', RAGGED,
                                                         descending=True),
    C('sort', X, 0), C('sort', X, descending=True), C('topk', X, 2),
    C('topk', X, 1, 0, False), C('where', B, X, Y), C('where', X > 0, X, 0.0),
    C('nonzero', B), C('nonzero', B, True), C('where', B),
    C('searchsorted', SORTED, V), C('searchsorted', SORTED, V, right=True),
    C('kthvalue', X, 2), C('kthvalue', X, 1, 0, True),
    C('mode', np.array([[1, 2, 2, 3, 3], [4, 4, 1, 1, 0]], np.int64)),
    # -- statistics -----------------------------------------------------
    C('var', X), C('var', X, 1, False), C('std', X, 0, True, True),
    C('std', XI), C('median', EVEN), C('median', EVEN, 1),
    C('median', X, 0, True), C('quantile', EVEN, 0.3),
    C('quantile', EVEN, [0.2, 0.7], 1), C('nanmedian', EVEN, 1),
    C('nanquantile', EVEN, 0.5, [0, 1], True),
    # -- linear algebra -------------------------------------------------
    C('matmul', X, Y, False, True), C('matmul', M3, M3),
    C('matmul', X.T.copy(), V, True), C('dot', X, Y), C('mm', X, Y.T),
    C('bmm', M3, M3), C('mv', X, V), C('addmm', SQ, SQ, SQ, 0.5, 2.0),
    C('norm', X), C('norm', X, 1, 1), C('norm', X, float('inf'), 0),
    C('norm', X, 'fro', [0, 1]), C('norm', X, 0), C('norm', X, 3, 1, True),
    C('dist', X, Y), C('dist', X, Y, 1), C('dist', X, Y, float('inf')),
    C('dist', X, Y, 0),
    *[C(n, SPD, tol=LOOSE) for n in ('cholesky', 'inv', 'inverse', 'det',
                                     'slogdet', 'eigvalsh', 'pinv', 'cond')],
    C('cholesky', SPD, True, tol=LOOSE), C('solve', SQ, X[:, :2],
                                           tol=LOOSE),
    C('triangular_solve', np.triu(SQ), X, tol=LOOSE),
    C('triangular_solve', np.tril(SQ), X, False, True, tol=LOOSE),
    C('cholesky_solve', X, np.linalg.cholesky(SPD).astype(np.float32),
      tol=LOOSE),
    C('matrix_power', SQ, 3, tol=LOOSE), C('matrix_rank', SQ),
    C('matrix_rank', np.ones((3, 3), np.float32)),
    C('cross', C3, C3[::-1].copy()), C('cross', C3, C3 * 2, 1),
    C('multi_dot', [X, Y.T, X]), C('histogram', X, 4),
    C('histogram', X, 5, -1, 1), C('bincount', RAGGED),
    C('bincount', RAGGED, np.arange(7, dtype=np.float32), 6),
    C('corrcoef', X, tol=LOOSE), C('cov', X, tol=LOOSE),
    C('cov', X, False, False, tol=LOOSE), C('t', X), C('einsum', 'ij,kj->ik',
                                                        X, Y),
    C('einsum', 'bij,bjk->bik', M3, M3),
    # -- attributes -----------------------------------------------------
    C('shape', T3), C('rank', T3), C('real', X), C('imag', X),
    C('is_floating_point', X), C('is_integer', XI), C('is_complex', X),
    # -- activations (nn.functional) ------------------------------------
    *[C(n, X, **act) for n in (
        'relu', 'relu6', 'elu', 'selu', 'celu', 'gelu', 'leaky_relu',
        'sigmoid', 'hardsigmoid', 'hardswish', 'hardtanh', 'hardshrink',
        'softshrink', 'tanhshrink', 'softsign', 'softplus', 'swish', 'silu',
        'mish', 'tanh', 'thresholded_relu', 'log_sigmoid', 'softmax',
        'log_softmax', 'glu')],
    C('gelu', X, True, **act), C('elu', X, 0.5, **act),
    C('celu', X, 2.0, **act), C('leaky_relu', X, 0.2, **act),
    C('hardtanh', X, -0.3, 0.4, **act), C('softplus', 3 * X, 2, 5, **act),
    C('softmax', X, 0, **act), C('log_softmax', X, 0, 'float32', **act),
    C('thresholded_relu', X, 0.5, **act), C('glu', T3, 2, **act),
    C('maxout', RNG.randn(2, 4, 3).astype(np.float32), 2, **act),
    C('maxout', RNG.randn(2, 3, 6).astype(np.float32), 3, -1, **act),
    C('prelu', T3, np.array([0.25], np.float32), **act),
    C('prelu', T3, np.array([0.1, 0.2, 0.3], np.float32), **act),
    C('prelu', T3, np.array([0.1, 0.2, 0.3, 0.4], np.float32), 'NHWC',
      **act),
    C('rrelu', X, **act),
]


@pytest.fixture(autouse=True)
def _on_cpu():
    saved = dict(device_mod._STATE)
    device_mod.set_device('cpu')
    yield
    device_mod._STATE.update(saved)


def _jax_arg(a):
    return paddle.to_tensor(a) if isinstance(a, np.ndarray) else \
        [_jax_arg(e) for e in a] if isinstance(a, list) and a and \
        isinstance(a[0], np.ndarray) else a


def _port_arg(a):
    return torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray) else \
        [_port_arg(e) for e in a] if isinstance(a, list) and a and \
        isinstance(a[0], np.ndarray) else a


def _jax_np(out):
    if isinstance(out, (list, tuple)):
        return [_jax_np(o) for o in out]
    if hasattr(out, '_data'):
        return np.asarray(out.numpy())
    return np.asarray(out)


def _port_np(out):
    if isinstance(out, (list, tuple)):
        return [_port_np(o) for o in out]
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return np.asarray(out)


def _compare(got, want, tol, where):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _compare(g, w, tol, '%s[%d]' % (where, i))
        return
    assert got.shape == want.shape, (where, got.shape, want.shape)
    assert got.dtype.kind == want.dtype.kind, (where, got.dtype, want.dtype)
    if want.dtype.kind in 'fc':
        np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1],
                                   err_msg=where)
    else:
        np.testing.assert_array_equal(got, want, err_msg=where)


@pytest.mark.parametrize('name, fn, args, kw, tol', CASES)
def test_function_matches_jax(name, fn, args, kw, tol):
    jfn = fn(paddle, name) if fn else getattr(paddle, name)
    tfn = fn(tpt, name) if fn else getattr(tpt.tensor, name)
    want = _jax_np(jfn(*[_jax_arg(a) for a in args], **kw))
    got = _port_np(tfn(*[_port_arg(a) for a in args], **kw))
    _compare(got, want, tol, name)


def test_every_jax_tensor_function_has_a_counterpart():
    import paddle_tpu.tensor as jt
    wanted = set()
    for mod in (jt.creation, jt.manipulation, jt.linalg, jt.logic,
                jt.search, jt.stat, jt.attribute, jt.random_ops,
                jt.inplace):
        wanted |= set(mod.__all__)
    wanted |= {n for n in dir(jt.math) if not n.startswith('_') and
               callable(getattr(jt.math, n)) and
               getattr(getattr(jt.math, n), '__module__', '').startswith(
                   'paddle_tpu.tensor') and n not in dir(jt._helpers)}
    wanted.add('einsum')
    missing = sorted(n for n in wanted if not hasattr(tpt.tensor, n))
    assert not missing, missing
    tested = {p.values[0] for p in CASES}
    assert len(tested) > 200, len(tested)


def test_in_place_forms_update_and_return_x():
    x = torch.from_numpy(P.copy())
    for name, args, want in (('add_', (1.0,), P + 1),
                             ('subtract_', (0.5,), P + 0.5),
                             ('scale_', (2.0,), 2 * P + 1),
                             ('clip_', (1.0, 2.0), np.clip(2 * P + 1, 1, 2)),
                             ('sqrt_', (), np.sqrt(np.clip(2 * P + 1, 1, 2))),
                             ('exp_', (), None), ('floor_', (), None)):
        out = getattr(tpt.tensor, name)(x, *args)
        assert out is x, name
        if want is not None:
            np.testing.assert_allclose(x.numpy(), want, rtol=1e-6)
    y = torch.arange(6.0)
    assert tpt.tensor.reshape_(y, [2, -1]) is y and y.shape == (2, 3)
    assert tpt.tensor.unsqueeze_(y, 0) is y and y.shape == (1, 2, 3)
    assert tpt.tensor.squeeze_(y) is y and y.shape == (2, 3)
    assert tpt.tensor.flatten_(y) is y and y.shape == (6,)
    z = torch.zeros(4)
    tpt.tensor.scatter_(z, torch.tensor([1, 1]), torch.tensor([2.0, 3.0]),
                        overwrite=False)
    assert z.tolist() == [0.0, 5.0, 0.0, 0.0]
    m = torch.zeros(5, 3)
    tpt.tensor.fill_diagonal_(m, 1.0, wrap=True)
    want = np.zeros((5, 3))
    np.fill_diagonal(want, 1.0, wrap=True)
    np.testing.assert_array_equal(m.numpy(), want)
    leaf = torch.ones(2, requires_grad=True)
    with pytest.raises(RuntimeError, match='leaf'):
        tpt.tensor.add_(leaf, 1.0)
    arr = tpt.tensor.array_write(torch.ones(1), 2)
    assert int(tpt.tensor.array_length(arr)) == 3 and \
        tpt.tensor.array_read(arr, 2).item() == 1.0
    c = torch.zeros(())
    assert tpt.tensor.increment(c, 2.0) is c and c.item() == 2.0
    t = torch.zeros(3)
    assert tpt.tanh_(t) is t and TF.relu_(t) is t


def test_gradients_flow_through_the_functions():
    x = torch.from_numpy(X.copy()).requires_grad_(True)
    T = tpt.tensor
    loss = T.sum(T.multiply(T.exp(T.gather(x, torch.tensor([2, 0]))), 2.0)) \
        + T.mean(T.concat([x, x], 1)) + T.logsumexp(x)
    loss.backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


# -- the random functions, by distribution --------------------------------

N = 20000


def _gen(s=5):
    return torch.Generator().manual_seed(s)


def test_random_draws_have_the_jax_distributions():
    T = tpt.tensor
    paddle.seed(7)
    cases = [
        ('uniform', T.uniform([N], min=-2.0, max=3.0, generator=_gen()),
         paddle.uniform([N], min=-2.0, max=3.0), 0.5, 25 / 12.0),
        ('rand', T.rand([N], generator=_gen()), paddle.rand([N]), 0.5,
         1 / 12.0),
        ('randn', T.randn([N], generator=_gen()), paddle.randn([N]), 0.0,
         1.0),
        ('normal', T.normal(1.5, 2.0, [N], generator=_gen()),
         paddle.normal(1.5, 2.0, [N]), 1.5, 4.0),
        ('poisson', T.poisson(torch.full([N], 3.0), generator=_gen()),
         paddle.poisson(paddle.full([N], 3.0)), 3.0, 3.0),
        ('bernoulli', T.bernoulli(torch.full([N], 0.3), generator=_gen()),
         paddle.bernoulli(paddle.full([N], 0.3)), 0.3, 0.21),
        ('exponential_', T.exponential_(torch.zeros(N), 2.0,
                                        generator=_gen()),
         paddle.tensor.random_ops.exponential_(paddle.zeros([N]), 2.0), 0.5,
         0.25),
        ('randint', T.randint(0, 10, [N], generator=_gen()).float(),
         paddle.randint(0, 10, [N]).astype('float32'), 4.5, 8.25),
    ]
    for name, got, want, mean, var in cases:
        g = got.double().numpy()
        w = np.asarray(want.numpy(), np.float64)
        se = np.sqrt(var / N)
        assert abs(g.mean() - mean) < 5 * se, (name, g.mean(), mean)
        assert abs(w.mean() - mean) < 5 * se, (name, w.mean(), mean)
        assert abs(g.var() - w.var()) < 0.1 * var, (name, g.var(), w.var())
    lo = T.uniform([N], min=-2.0, max=3.0, generator=_gen())
    assert lo.min() >= -2.0 and lo.max() < 3.0
    ri = T.randint(3, 7, [N], generator=_gen())
    assert ri.dtype == torch.int64 and set(ri.unique().tolist()) == \
        {3, 4, 5, 6}
    perm = T.randperm(50, generator=_gen())
    assert sorted(perm.tolist()) == list(range(50))
    probs = torch.tensor([[0.1, 0.6, 0.3]]).repeat(4000, 1)
    draws = T.multinomial(probs, 1, generator=_gen())[:, 0]
    freq = torch.bincount(draws, minlength=3).double() / 4000
    assert torch.allclose(freq, probs[0].double(), atol=0.03)
    no_rep = T.multinomial(torch.ones(2, 5), 5, generator=_gen())
    assert all(sorted(r) == list(range(5)) for r in no_rep.tolist())


def test_random_draws_repeat_under_a_seed_and_advance_without_one():
    T = tpt.tensor
    a = T.randn([8], generator=_gen(3))
    assert torch.equal(a, T.randn([8], generator=_gen(3)))
    gen = _gen(3)
    first, second = T.rand([8], generator=gen), T.rand([8], generator=gen)
    assert not torch.equal(first, second)
    # seed != 0: a draw of its own, whatever the stream
    assert torch.equal(T.uniform([4], seed=11), T.uniform([4], seed=11))
    x = torch.empty(6)
    assert T.uniform_(x, 0.0, 1.0, seed=11) is x
    assert torch.equal(x, T.uniform([6], min=0.0, max=1.0, seed=11))
    assert T.normal_(x, 0.0, 1.0, generator=_gen()) is x
    assert T.randint_like(torch.zeros(3, dtype=torch.int32), 0, 4,
                          generator=_gen()).dtype == torch.int32
    T.check_shape([2, -1])
    with pytest.raises(ValueError, match='at most one'):
        T.check_shape([-1, -1])


def test_random_activations_draw_from_their_generator():
    x = torch.from_numpy(-np.abs(RNG.randn(2000)).astype(np.float32) - 0.1)
    y = TF.rrelu(x, 0.1, 0.3, training=True, generator=_gen())
    slope = (y / x).numpy()
    assert slope.min() >= 0.1 - 1e-6 and slope.max() <= 0.3 + 1e-6
    assert abs(slope.mean() - 0.2) < 0.01
    assert torch.equal(y, TF.rrelu(x, 0.1, 0.3, training=True,
                                   generator=_gen()))
    jy = np.asarray(JF.rrelu(paddle.to_tensor(x.numpy()), 0.1, 0.3,
                             training=True).numpy())
    assert abs((jy / x.numpy()).mean() - slope.mean()) < 0.01
    logits = torch.from_numpy(RNG.randn(3000, 4).astype(np.float32))
    soft = TF.gumbel_softmax(logits, 0.5, generator=_gen())
    assert torch.allclose(soft.sum(-1), torch.ones(3000), atol=1e-5)
    hard = TF.gumbel_softmax(logits, 0.5, hard=True, generator=_gen())
    assert set(hard.unique().tolist()) == {0.0, 1.0}
    assert torch.equal(hard.argmax(-1), soft.argmax(-1))
    # the argmax of logits + Gumbel noise is a draw from softmax(logits)
    freq = torch.bincount(hard.argmax(-1), minlength=4).double() / 3000
    jhard = np.asarray(JF.gumbel_softmax(paddle.to_tensor(logits.numpy()),
                                         0.5, hard=True).numpy())
    jfreq = np.bincount(jhard.argmax(-1), minlength=4) / 3000
    want = torch.softmax(logits.double(), -1).mean(0)
    assert torch.allclose(freq, want, atol=0.03)
    assert np.allclose(jfreq, want.numpy(), atol=0.03)


# -- activation layers, containers, distance ------------------------------

LAYERS = [('ReLU', ()), ('ReLU6', ()), ('ELU', (0.5,)), ('SELU', ()),
          ('CELU', (2.0,)), ('GELU', (True,)), ('LeakyReLU', (0.2,)),
          ('Sigmoid', ()), ('Hardsigmoid', ()), ('Hardswish', ()),
          ('Hardtanh', (-0.5, 0.5)), ('Hardshrink', (0.3,)),
          ('Softshrink', (0.3,)), ('Tanhshrink', ()), ('Softsign', ()),
          ('Softplus', (2, 10)), ('Swish', ()), ('Silu', ()), ('Mish', ()),
          ('Tanh', ()), ('ThresholdedReLU', (0.4,)), ('LogSigmoid', ()),
          ('Maxout', (2,)), ('Softmax', (1,)), ('LogSoftmax', (0,)),
          ('GLU', (1,)), ('RReLU', ())]


@pytest.mark.parametrize('name, args', LAYERS)
def test_activation_layer_matches_jax(name, args):
    x = RNG.randn(2, 4, 3).astype(np.float32)
    jl = getattr(paddle.nn, name)(*args)
    tl = getattr(tpt.nn, name)(*args)
    jl.eval()
    tl.eval()
    want = np.asarray(jl(paddle.to_tensor(x)).numpy())
    got = tl(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_prelu_layer_learns_its_weight():
    x = RNG.randn(2, 3, 4).astype(np.float32)
    jl = paddle.nn.PReLU(3, 0.1)
    tl = tpt.nn.PReLU(3, 0.1, device='cpu')
    assert tl.weight.shape == (3,) and torch.allclose(tl.weight,
                                                      torch.full((3,), 0.1))
    out = tl(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jl(paddle.to_tensor(x)).numpy()),
                               rtol=1e-6)
    out.sum().backward()
    assert tl.weight.grad.shape == (3,)


def test_containers_keep_paddles_names_and_methods():
    nn = tpt.nn
    seq = nn.Sequential(nn.Linear(4, 3, device='cpu'), nn.ReLU(),
                        nn.Linear(3, 2, device='cpu'))
    assert len(seq) == 3 and isinstance(seq[1], nn.ReLU)
    assert isinstance(seq[:2], nn.Sequential) and len(seq[:2]) == 2
    assert seq(torch.randn(5, 4)).shape == (5, 2)
    named = nn.Sequential(('a', nn.Tanh()), ('b', nn.Sigmoid()))
    assert list(dict(named.named_children())) == ['a', 'b']
    import collections
    od = nn.Sequential(collections.OrderedDict([('x', nn.ReLU())]))
    assert isinstance(od.x, nn.ReLU)
    ll = nn.LayerList([nn.ReLU()])
    ll.append(nn.Tanh())
    ll.insert(0, nn.Sigmoid())
    ll.extend([nn.GELU()])
    assert [type(m).__name__ for m in ll] == ['Sigmoid', 'ReLU', 'Tanh',
                                              'GELU']
    assert isinstance(ll[-1], nn.GELU) and len(ll[1:]) == 3
    ld = nn.LayerDict({'r': nn.ReLU()})
    ld['t'] = nn.Tanh()
    ld.update([('s', nn.Sigmoid())])
    assert list(ld.keys()) == ['r', 't', 's'] and 't' in ld
    assert isinstance(ld.pop('r'), nn.ReLU) and len(ld) == 2
    ld.clear()
    assert len(ld) == 0
    pl = nn.ParameterList([torch.nn.Parameter(torch.ones(2))])
    pl.append(torch.nn.Parameter(torch.zeros(3)))
    assert len(pl) == 2 and pl[-1].shape == (3,)
    holder = torch.nn.Module()
    holder.layers, holder.params = ll, pl
    assert len(list(holder.parameters())) == 2


def test_pairwise_distance_matches_jax():
    a, b = X, Y
    for p, keep in ((2.0, False), (1.0, True), (3.0, False)):
        want = np.asarray(paddle.nn.PairwiseDistance(p, keepdim=keep)(
            paddle.to_tensor(a), paddle.to_tensor(b)).numpy())
        got = tpt.nn.PairwiseDistance(p, keepdim=keep)(
            torch.from_numpy(a), torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_activations_cast_under_auto_cast():
    from paddle_tpu_torch.amp import auto_cast
    x = torch.randn(4, 8)
    with auto_cast(True, level='O2', dtype='bfloat16'):
        assert TF.relu(x).dtype == torch.bfloat16
        assert TF.gelu(x).dtype == torch.bfloat16
        assert TF.softmax(x).dtype == torch.float32  # black-listed
    with auto_cast(True, level='O1', dtype='bfloat16'):
        assert TF.silu(x.bfloat16()).dtype == torch.float32


# -- the top-level names and the flags ------------------------------------

def test_top_level_names_are_present_or_absent_with_a_reason():
    import ast
    import os
    path = os.path.join(os.path.dirname(paddle.__file__), '__init__.py')
    tree = ast.parse(open(path).read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split('.')[0] for a in node.names
                      if a.name != '*'}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    names = {n for n in names if not n.startswith('_')}
    assert len(names) > 80
    # since slice 23 no name is absent (the name of this test predates
    # that): every public top-level name of the JAX package resolves
    absent = [name for name in sorted(names) if not hasattr(tpt, name)]
    assert absent == []
    assert not hasattr(tpt, '_ABSENT')
    # and every tensor function the JAX package exports at the top
    assert all(hasattr(tpt, n) for n in tpt.tensor.__all__)


def test_absent_device_places_and_patch_no_ops():
    """XPUPlace / NPUPlace are place classes, as in the JAX package, of
    devices the port does not run on: placing a tensor on one raises a
    ValueError that names it. The patch functions change nothing."""
    from paddle_tpu import NPUPlace as JNPUPlace, XPUPlace as JXPUPlace
    for cls, jcls in ((tpt.XPUPlace, JXPUPlace), (tpt.NPUPlace, JNPUPlace)):
        place = cls(1)
        assert place == cls(1) and place != cls(0)
        assert place.device_id == place.get_device_id() == \
            jcls(1).device_id == 1
        assert repr(place) == '%s(1)' % cls.__name__
        with pytest.raises(ValueError, match=r'%s\(1\).*CUDA GPUs and the '
                           'CPU' % cls.__name__):
            tpt.to_tensor([1.0], place=place)
        with pytest.raises(ValueError, match=cls.__name__):
            place.device
    methods = dict(vars(torch.Tensor))
    assert tpt.monkey_patch_math_varbase() is None
    assert tpt.monkey_patch_variable() is None
    assert dict(vars(torch.Tensor)) == methods
    assert tpt.onnx.export is tpt.onnx.__dict__['export']


def test_top_level_values():
    assert tpt.float32 is torch.float32 and tpt.bool is torch.bool
    assert tpt.int64 is torch.int64 and tpt.bfloat16 is torch.bfloat16
    assert tpt.Tensor is torch.Tensor and tpt.Parameter is torch.nn.Parameter
    assert tpt.is_tensor(torch.ones(1)) and not tpt.is_tensor(1.0)
    t = tpt.to_tensor([1.0, 2.0], place='cpu', stop_gradient=False)
    assert t.dtype == torch.float32 and t.requires_grad
    assert tpt.to_tensor([1, 2], place=tpt.CPUPlace()).dtype == torch.int64
    assert tpt.to_tensor(np.ones(2), dtype='float16',
                         place='cpu').dtype == torch.float16
    assert tpt.CUDAPlace(1).device == torch.device('cuda', 1)
    assert tpt.is_compiled_with_cuda() == (torch.version.cuda is not None)
    assert tpt.is_compiled_with_xpu() is False
    assert tpt.in_dynamic_mode() and tpt.in_dygraph_mode()
    try:
        tpt.enable_static()
        assert not tpt.in_dynamic_mode()
    finally:
        tpt.disable_static()
    assert tpt.in_dynamic_mode()
    assert tpt.einsum('i,i->', torch.ones(3), torch.ones(3)).item() == 3.0
    assert tpt.get_cuda_rng_state is tpt.get_rng_state
    p = tpt.create_parameter([2, 3], 'float32')
    assert isinstance(p, torch.nn.Parameter) and p.shape == (2, 3)
    assert tpt.crop_tensor(torch.arange(6).reshape(2, 3), [1, 2],
                           [1, 1]).tolist() == [[4, 5]]


def test_seed_and_default_dtype_restore():
    state = tpt.get_rng_state()
    try:
        tpt.seed(123)
        a = torch.rand(3)
        tpt.seed(123)
        assert torch.equal(a, torch.rand(3))
    finally:
        tpt.set_rng_state(state)
    assert tpt.get_default_dtype() == 'float32'
    try:
        tpt.set_default_dtype('float64')
        assert tpt.to_tensor([1.5], place='cpu').dtype == torch.float64
        assert tpt.zeros([2]).dtype == torch.float64
        with pytest.raises(TypeError):
            tpt.set_default_dtype('int32')
    finally:
        tpt.set_default_dtype('float32')


def test_save_and_load_round_trip(tmp_path):
    obj = {'w': torch.arange(4.0), 'n': 3}
    tpt.save(obj, str(tmp_path / 'x.pdparams'))
    back = tpt.load(str(tmp_path / 'x.pdparams'))
    assert torch.equal(back['w'], obj['w']) and back['n'] == 3


@pytest.fixture
def _flags_restored():
    from paddle_tpu_torch.framework import flags
    saved = {k: f.value for k, f in flags._REGISTRY.items()}
    precision = torch.get_float32_matmul_precision()
    deterministic = torch.backends.cudnn.deterministic
    anomaly = torch.is_anomaly_enabled()
    yield flags
    for k in list(flags._REGISTRY):
        if k not in saved:
            del flags._REGISTRY[k]
        else:
            flags._REGISTRY[k].value = saved[k]
    torch.set_float32_matmul_precision(precision)
    torch.backends.cudnn.deterministic = deterministic
    torch.autograd.set_detect_anomaly(anomaly)


def test_flags_map_onto_torch(_flags_restored):
    assert tpt.get_flags('FLAGS_cudnn_deterministic') == {
        'FLAGS_cudnn_deterministic': True}
    tpt.set_flags({'FLAGS_tpu_matmul_precision': 'tensorfloat32'})
    assert torch.get_float32_matmul_precision() == 'high'
    tpt.set_flags({'tpu_matmul_precision': 'default'})
    assert torch.get_float32_matmul_precision() == 'highest'
    with pytest.raises(ValueError, match='tpu_matmul_precision'):
        tpt.set_flags({'tpu_matmul_precision': 'fast'})
    tpt.set_flags({'cudnn_deterministic': 'false'})
    assert torch.backends.cudnn.deterministic is False
    assert tpt.get_flags(['cudnn_deterministic']) == {
        'cudnn_deterministic': False}
    tpt.set_flags({'check_nan_inf': True})
    assert torch.is_anomaly_enabled()
    tpt.set_flags({'FLAGS_my_flag': 3, 'benchmark': True})
    assert tpt.get_flags(['my_flag', 'benchmark', 'unknown']) == {
        'my_flag': 3, 'benchmark': True}
    # the JAX package's registry holds the same flags and defaults
    from paddle_tpu.framework import flags as jflags
    for name, f in jflags._REGISTRY.items():
        if name in _flags_restored._REGISTRY and name not in (
                'cudnn_deterministic', 'tpu_matmul_precision', 'benchmark',
                'check_nan_inf', 'my_flag'):
            assert _flags_restored._REGISTRY[name].value == f.value, name
    assert set(jflags._REGISTRY) <= set(_flags_restored._REGISTRY)
