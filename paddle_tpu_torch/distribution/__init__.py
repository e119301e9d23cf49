"""Probability distributions (reference: python/paddle/distribution.py;
counterpart of paddle_tpu/distribution/__init__.py).

The parameters are tensors: a tensor as it is, anything else a new tensor
on the current device (framework/device.py; Python numbers in the default
float dtype). `log_prob`, `probs`, `entropy` and `kl_divergence` are the
JAX package's formulas in torch ops. `sample` draws on the parameters'
device from `generator` (keyword-only: a torch.Generator on that device,
that device's default generator when None), as the port's dropout draws,
with the JAX package's shapes and dtypes. JAX's threefry bits cannot be
reproduced, so draws agree with the JAX package's in distribution, not
bit for bit.
"""
import math

import torch

from ..tensor._helpers import as_tensor, ensure_tensor
from ..tensor.random import _gen

__all__ = ['Distribution', 'Normal', 'Uniform', 'Categorical', 'Beta',
           'Dirichlet', 'Exponential', 'Bernoulli', 'Multinomial',
           'kl_divergence']


def _arr(x):
    return as_tensor(float(x) if isinstance(x, (int, float)) else x)


def _in_f64(fn, *ts):
    """fn over the tensors in float64, returned in their promoted dtype.
    The log-gamma and digamma terms are summed so: in f32 their
    differences lose digits, and torch's and XLA's f32 lgamma lose
    different ones (each up to ~2e-6 from the exact value at these
    parameters); in f64 the result is the exact value, rounded once."""
    return fn(*(t.double() for t in ts)).to(_dtype(*ts))


def _betaln(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def _bshape(*ts):
    return tuple(torch.broadcast_shapes(*(t.shape for t in ts)))


def _dtype(*ts):
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return dt if dt.is_floating_point else torch.float32


class Distribution:
    def sample(self, shape=()):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def probs(self, value):
        return torch.exp(self.log_prob(value))


class Normal(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc = _arr(loc)
        self.scale = _arr(scale)

    def sample(self, shape=(), seed=0, *, generator=None):
        # `seed` is the JAX package's unused parameter, kept for its callers
        shp = tuple(shape) + _bshape(self.loc, self.scale)
        dev = self.loc.device
        eps = torch.randn(shp, dtype=_dtype(self.loc, self.scale),
                          device=dev, generator=_gen(generator, dev))
        return self.loc + self.scale * eps

    def rsample(self, shape=(), *, generator=None):
        return self.sample(shape, generator=generator)

    def entropy(self):
        return 0.5 + 0.5 * math.log(2 * math.pi) + \
            torch.log(self.scale) * torch.ones_like(self.loc)

    def log_prob(self, value):
        x = ensure_tensor(value, like=self.loc)
        var = self.scale ** 2
        return -((x - self.loc) ** 2) / (2 * var) - torch.log(self.scale) \
            - 0.5 * math.log(2 * math.pi)

    def kl_divergence(self, other):
        var_a = self.scale ** 2
        var_b = other.scale ** 2
        return torch.log(other.scale / self.scale) + \
            (var_a + (self.loc - other.loc) ** 2) / (2 * var_b) - 0.5


class Uniform(Distribution):
    def __init__(self, low, high, name=None):
        self.low = _arr(low)
        self.high = _arr(high)

    def sample(self, shape=(), seed=0, *, generator=None):
        shp = tuple(shape) + _bshape(self.low, self.high)
        dev = self.low.device
        u = torch.rand(shp, dtype=_dtype(self.low, self.high), device=dev,
                       generator=_gen(generator, dev))
        return self.low + (self.high - self.low) * u

    def entropy(self):
        return torch.log(self.high - self.low)

    def log_prob(self, value):
        x = ensure_tensor(value, like=self.low)
        inside = (x >= self.low) & (x < self.high)
        lp = -torch.log(self.high - self.low)
        return torch.where(inside, lp, torch.full_like(lp, -math.inf))


def _gumbel_argmax(logits, shape, generator):
    """Categorical draws of `shape` (ending in logits.shape[:-1]) by the
    Gumbel-max rule, as jax.random.categorical draws."""
    e = torch.empty(tuple(shape) + logits.shape[-1:], dtype=logits.dtype,
                    device=logits.device).exponential_(
                        generator=_gen(generator, logits.device))
    return torch.argmax(logits - torch.log(e), dim=-1)


class Categorical(Distribution):
    def __init__(self, logits, name=None):
        self.logits = _arr(logits)

    def sample(self, shape=(), *, generator=None):
        shp = tuple(shape) + tuple(self.logits.shape[:-1])
        return _gumbel_argmax(self.logits, shp, generator).to(torch.int64)

    def entropy(self):
        p = torch.softmax(self.logits, -1)
        logp = torch.log_softmax(self.logits, -1)
        return -torch.sum(p * logp, -1)

    def _take(self, table, value):
        v = ensure_tensor(value, like=self.logits).to(torch.int64)
        return torch.take_along_dim(table, v[..., None], -1)[..., 0]

    def log_prob(self, value):
        return self._take(torch.log_softmax(self.logits, -1), value)

    def probs(self, value):
        return self._take(torch.softmax(self.logits, -1), value)

    def kl_divergence(self, other):
        p = torch.softmax(self.logits, -1)
        return torch.sum(p * (torch.log_softmax(self.logits, -1) -
                              torch.log_softmax(other.logits, -1)), -1)


class Beta(Distribution):
    def __init__(self, alpha, beta):
        self.alpha = _arr(alpha)
        self.beta = _arr(beta)

    def sample(self, shape=(), *, generator=None):
        shp = tuple(shape) + _bshape(self.alpha, self.beta)
        dt = _dtype(self.alpha, self.beta)
        gen = _gen(generator, self.alpha.device)
        x = torch._standard_gamma(self.alpha.to(dt).expand(shp).contiguous(),
                                  generator=gen)
        y = torch._standard_gamma(self.beta.to(dt).expand(shp).contiguous(),
                                  generator=gen)
        return x / (x + y)

    def log_prob(self, value):
        v = ensure_tensor(value, like=self.alpha)
        return (self.alpha - 1) * torch.log(v) + \
            (self.beta - 1) * torch.log1p(-v) - \
            _in_f64(_betaln, self.alpha, self.beta)

    def entropy(self):
        def fn(a, b):
            return _betaln(a, b) - (a - 1) * torch.digamma(a) - \
                (b - 1) * torch.digamma(b) + \
                (a + b - 2) * torch.digamma(a + b)
        return _in_f64(fn, self.alpha, self.beta)


class Dirichlet(Distribution):
    def __init__(self, concentration):
        self.concentration = _arr(concentration)

    def sample(self, shape=(), *, generator=None):
        # jax.random.dirichlet's shape: `shape` is the batch shape (it
        # takes the concentration's batch dims), the draws end in K
        a = self.concentration
        shp = tuple(shape) + tuple(a.shape[-1:])
        g = torch._standard_gamma(a.to(_dtype(a)).expand(shp).contiguous(),
                                  generator=_gen(generator, a.device))
        return g / g.sum(-1, keepdim=True)

    def log_prob(self, value):
        v = ensure_tensor(value, like=self.concentration)
        a = self.concentration
        return torch.sum((a - 1) * torch.log(v), -1) + _in_f64(
            lambda a: torch.lgamma(torch.sum(a, -1)) -
            torch.sum(torch.lgamma(a), -1), a)


class Exponential(Distribution):
    def __init__(self, rate):
        self.rate = _arr(rate)

    def sample(self, shape=(), *, generator=None):
        shp = tuple(shape) + tuple(self.rate.shape)
        e = torch.empty(shp, dtype=_dtype(self.rate),
                        device=self.rate.device).exponential_(
                            generator=_gen(generator, self.rate.device))
        return e / self.rate

    def log_prob(self, value):
        v = ensure_tensor(value, like=self.rate)
        return torch.log(self.rate) - self.rate * v

    def entropy(self):
        return 1.0 - torch.log(self.rate)


class Bernoulli(Distribution):
    def __init__(self, probs):
        self.p = _arr(probs)

    def sample(self, shape=(), *, generator=None):
        shp = tuple(shape) + tuple(self.p.shape)
        u = torch.rand(shp, dtype=_dtype(self.p), device=self.p.device,
                       generator=_gen(generator, self.p.device))
        return (u < self.p).to(torch.float32)

    def log_prob(self, value):
        v = ensure_tensor(value, like=self.p)
        return v * torch.log(self.p) + (1 - v) * torch.log1p(-self.p)

    def entropy(self):
        p = self.p
        return -(p * torch.log(p) + (1 - p) * torch.log1p(-p))


class Multinomial(Distribution):
    def __init__(self, total_count, probs):
        self.n = int(total_count)
        self.p = _arr(probs)

    def sample(self, shape=(), *, generator=None):
        logits = torch.log(torch.clamp_min(self.p, 1e-30))
        shp = tuple(shape) + (self.n,) + tuple(self.p.shape[:-1])
        draws = _gumbel_argmax(logits, shp, generator)
        k = self.p.shape[-1]
        onehot = torch.nn.functional.one_hot(draws, k).to(torch.float32)
        return torch.sum(onehot, dim=len(shape))


def kl_divergence(p, q):
    return p.kl_divergence(q)
