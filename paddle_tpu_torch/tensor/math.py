"""Math functions (counterpart of paddle_tpu/tensor/math.py).

Elementwise functions that the JAX package computes in floating point
(exp, sqrt, the trigonometric functions, reciprocal, ...) take an integer
input as float32, as jnp does; the ones it keeps integral (abs, sign,
floor, round, ...) keep it so. Reductions take Paddle's `axis` (None, an
int or a list) and `keepdim`; `mean` of integers is float32.
"""
import builtins

import torch

from ._helpers import (axes_arg, binary_op, ensure_tensor, is_float,
                       promote, tdt, unary_op)

# -- elementwise unary ------------------------------------------------------
exp = unary_op('exp', torch.exp, True)
expm1 = unary_op('expm1', torch.expm1, True)
log = unary_op('log', torch.log, True)
log2 = unary_op('log2', torch.log2, True)
log10 = unary_op('log10', torch.log10, True)
log1p = unary_op('log1p', torch.log1p, True)
sqrt = unary_op('sqrt', torch.sqrt, True)
rsqrt = unary_op('rsqrt', torch.rsqrt, True)
square = unary_op('square', torch.square)
abs = unary_op('abs', torch.abs)
sign = unary_op('sign', torch.sign)
neg = unary_op('neg', torch.neg)
reciprocal = unary_op('reciprocal', torch.reciprocal, True)
sin = unary_op('sin', torch.sin, True)
cos = unary_op('cos', torch.cos, True)
tan = unary_op('tan', torch.tan, True)
asin = unary_op('asin', torch.asin, True)
acos = unary_op('acos', torch.acos, True)
atan = unary_op('atan', torch.atan, True)
sinh = unary_op('sinh', torch.sinh, True)
cosh = unary_op('cosh', torch.cosh, True)
tanh = unary_op('tanh', torch.tanh, True)
asinh = unary_op('asinh', torch.asinh, True)
acosh = unary_op('acosh', torch.acosh, True)
atanh = unary_op('atanh', torch.atanh, True)
erf = unary_op('erf', torch.erf, True)
erfinv = unary_op('erfinv', torch.erfinv, True)
floor = unary_op('floor', torch.floor)
ceil = unary_op('ceil', torch.ceil)
round = unary_op('round', torch.round)
trunc = unary_op('trunc', torch.trunc)
frac = unary_op('frac', lambda x: x - torch.trunc(x))
angle = unary_op('angle', torch.angle, True)
conj = unary_op('conj', torch.conj_physical)
digamma = unary_op('digamma', torch.digamma, True)
lgamma = unary_op('lgamma', torch.lgamma, True)
sigmoid = unary_op('sigmoid', torch.sigmoid, True)
i0 = unary_op('i0', torch.i0, True)

# -- elementwise binary -----------------------------------------------------
add = binary_op('add', torch.add)
subtract = binary_op('subtract', torch.subtract)
multiply = binary_op('multiply', torch.multiply)
divide = binary_op('divide', torch.true_divide, int_to_float=True)
floor_divide = binary_op('floor_divide', torch.floor_divide)
mod = binary_op('mod', torch.remainder)
remainder = mod
floor_mod = mod
pow = binary_op('pow', torch.pow)
maximum = binary_op('maximum', torch.maximum)
minimum = binary_op('minimum', torch.minimum)
fmax = binary_op('fmax', torch.fmax)
fmin = binary_op('fmin', torch.fmin)
atan2 = binary_op('atan2', torch.atan2, int_to_float=True)
hypot = binary_op('hypot', torch.hypot, int_to_float=True)
logaddexp = binary_op('logaddexp', torch.logaddexp, int_to_float=True)
heaviside = binary_op('heaviside', lambda a, b: torch.heaviside(
    a, b.to(a.dtype)))
nextafter = binary_op('nextafter', lambda a, b: torch.nextafter(
    a, b.to(a.dtype)), int_to_float=True)
copysign = binary_op('copysign', torch.copysign, int_to_float=True)
ldexp = binary_op('ldexp', torch.ldexp, int_to_float=True)
gcd = binary_op('gcd', torch.gcd)
lcm = binary_op('lcm', torch.lcm)
inner = binary_op('inner', torch.inner)
outer = binary_op('outer', torch.outer)
kron = binary_op('kron', torch.kron)

# legacy names
elementwise_add, elementwise_sub = add, subtract
elementwise_mul, elementwise_div = multiply, divide


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    x = ensure_tensor(x)
    s = scale.item() if isinstance(scale, torch.Tensor) else scale
    out = x * s + bias if bias_after_scale else (x + bias) * s
    if act:
        from ..nn import functional as F
        out = getattr(F, act)(out)
    return out


def increment(x, value=1.0, name=None):
    """x += value in place; returns x."""
    with torch.no_grad():
        return x.add_(value)


def clip(x, min=None, max=None, name=None):
    x = ensure_tensor(x)
    mn = min.item() if isinstance(min, torch.Tensor) else min
    mx = max.item() if isinstance(max, torch.Tensor) else max
    return torch.clamp(x, mn, mx)


def lerp(x, y, weight, name=None):
    x, y = promote(x, y)
    return x + weight * (y - x)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return scale_b * torch.tanh(scale_a * ensure_tensor(x))


def multiplex(inputs, index, name=None):
    stacked = torch.stack([ensure_tensor(t) for t in inputs])
    ix = ensure_tensor(index, stacked).reshape(-1).long()
    return stacked[ix, torch.arange(stacked.shape[1], device=stacked.device)]


# -- reductions -------------------------------------------------------------
def _reduce(fn, x, axis, keepdim, **kw):
    ax = axes_arg(axis)
    if ax is None:
        out = fn(x, **kw)
        return out.reshape((1,) * x.dim()) if keepdim else out
    return fn(x, dim=ax, keepdim=keepdim, **kw)


def _one_dim_at_a_time(fn):
    """A torch reduction that takes one dim, over a tuple of dims."""
    def reduce(x, dim=None, keepdim=False, **kw):
        if dim is None:
            return fn(x, **kw)
        if isinstance(dim, int):
            return fn(x, dim=dim, keepdim=keepdim, **kw)
        for d in sorted((d % x.dim() for d in dim), reverse=True):
            x = fn(x, dim=d, keepdim=keepdim, **kw)
        return x
    return reduce


def _reduction(op_name, fn, float_in=False):
    def op(x, axis=None, keepdim=False, name=None, dtype=None):
        x = ensure_tensor(x)
        if float_in and not is_float(x):
            x = x.to(torch.float32)
        kw = {} if dtype is None else {'dtype': tdt(dtype)}
        return _reduce(fn, x, axis, keepdim, **kw)
    op.__name__ = op.__qualname__ = op_name
    return op


sum = _reduction('sum', torch.sum)
prod = _reduction('prod', _one_dim_at_a_time(torch.prod))
mean = _reduction('mean', torch.mean, float_in=True)
max = _reduction('max', torch.amax)
min = _reduction('min', torch.amin)
amax = _reduction('amax', torch.amax)
amin = _reduction('amin', torch.amin)
nansum = _reduction('nansum', torch.nansum)
nanmean = _reduction('nanmean', torch.nanmean, float_in=True)
all = _reduction('all', torch.all)
any = _reduction('any', torch.any)


def logsumexp(x, axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    ax = axes_arg(axis)
    return torch.logsumexp(x, dim=tuple(range(x.dim())) if ax is None
                           else ax, keepdim=keepdim)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    return _reduce(lambda a, **k: torch.sum(a != 0, **k), x, axis, keepdim)


def cumsum(x, axis=None, dtype=None, name=None):
    x = ensure_tensor(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.cumsum(x, int(axis), dtype=tdt(dtype) if dtype else None)


def cumprod(x, dim=None, dtype=None, name=None):
    x = ensure_tensor(x)
    return torch.cumprod(x, int(dim), dtype=tdt(dtype) if dtype else None)


def _cum_extreme(fn, x, axis, dtype):
    """Running max / min and, for each position, the last index at which
    the running value was reached."""
    x = ensure_tensor(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    vals = fn(x, int(axis)).values
    ax = int(axis) % x.dim()
    ar = torch.arange(x.shape[ax], device=x.device).reshape(
        [-1 if i == ax else 1 for i in range(x.dim())])
    hit = torch.where(vals.detach() == x.detach(), ar, -1)
    return vals, torch.cummax(hit, ax).values.to(tdt(dtype))


def cummax(x, axis=None, dtype='int64', name=None):
    return _cum_extreme(torch.cummax, x, axis, dtype)


def cummin(x, axis=None, dtype='int64', name=None):
    return _cum_extreme(torch.cummin, x, axis, dtype)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    x = ensure_tensor(x)
    pre = None if prepend is None else ensure_tensor(prepend, x)
    app = None if append is None else ensure_tensor(append, x)
    return torch.diff(x, n, axis, pre, app)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(ensure_tensor(x), offset, axis1, axis2).sum(-1)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(ensure_tensor(x), offset, axis1, axis2)


# -- predicates (no grad) ---------------------------------------------------
def isfinite(x, name=None):
    return torch.isfinite(ensure_tensor(x))


def isinf(x, name=None):
    return torch.isinf(ensure_tensor(x))


def isnan(x, name=None):
    return torch.isnan(ensure_tensor(x))


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return torch.nan_to_num(ensure_tensor(x), nan, posinf, neginf)


# -- matmul family (also exported by linalg) --------------------------------
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    x, y = promote(x, y)
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def dot(x, y, name=None):
    x, y = promote(x, y)
    return torch.sum(x * y, dim=-1)


def mm(x, y, name=None):
    return matmul(x, y)


def bmm(x, y, name=None):
    return matmul(x, y)


def mv(x, vec, name=None):
    return matmul(x, vec)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return beta * ensure_tensor(input) + alpha * torch.matmul(
        ensure_tensor(x), ensure_tensor(y))


def rad2deg(x, name=None):
    return torch.rad2deg(ensure_tensor(x))


def deg2rad(x, name=None):
    return torch.deg2rad(ensure_tensor(x))


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def take(x, index, mode='raise', name=None):
    x = ensure_tensor(x)
    flat = x.reshape(-1)
    i = ensure_tensor(index, x).long()
    if mode == 'wrap':
        i = torch.remainder(i, flat.shape[0])
    elif mode == 'clip':
        i = torch.clamp(i, 0, flat.shape[0] - 1)
    return flat[i]


def add_n(inputs, name=None):
    """The elementwise sum of a list of tensors."""
    if isinstance(inputs, torch.Tensor):
        inputs = [inputs]
    return builtins.sum(inputs[1:], inputs[0])


def tanh_(x, name=None):
    """tanh in place; returns x."""
    return x.tanh_()


__all__ = sorted(
    n for n, v in list(globals().items())
    if callable(v) and not n.startswith('_') and not isinstance(v, type)
    and n not in ('axes_arg', 'binary_op', 'ensure_tensor', 'is_float',
                  'promote', 'tdt', 'unary_op'))
