"""The port's distributions (paddle_tpu_torch/distribution) against the JAX
package's on the same seeded float32 parameters and values.

`log_prob`, `probs`, `entropy` and `kl_divergence` are the same formulas
and must agree within 1e-6 (absolute and relative, f32). Beta and
Dirichlet go through log-gamma and digamma, which XLA's f32 computes up to
~2e-6 from the exact value at these parameters (the port sums those terms
in float64): there the port must be within 1e-6 of the exact value
(scipy.special in float64) and within 1e-6 of the JAX package's plus the
JAX package's own distance from it. Draws cannot
equal JAX's threefry bits, so the draws are held to the JAX package's
shapes and dtypes, to the closed-form mean and variance (2e5 seeded
draws within 5 standard errors) and to themselves under one seed.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import numpy as np
import pytest
import scipy.special as sp
import torch

import jax

import paddle_tpu as paddle
import paddle_tpu.distribution as JD

import paddle_tpu_torch.distribution as TD

TOL = 1e-6
DRAWS = 200_000
R = np.random.RandomState(0)
LOC = R.randn(3).astype(np.float32)
SCALE = R.uniform(0.5, 2.0, 3).astype(np.float32)
LOW = R.uniform(-2, 0, 3).astype(np.float32)
HIGH = (LOW + R.uniform(0.5, 3, 3)).astype(np.float32)
LOGITS = R.randn(2, 5).astype(np.float32)
ALPHA = R.uniform(0.5, 4, 3).astype(np.float32)
BETA = R.uniform(0.5, 4, 3).astype(np.float32)
CONC = R.uniform(0.5, 4, (2, 4)).astype(np.float32)
RATE = R.uniform(0.5, 3, 3).astype(np.float32)
PROBS = R.uniform(0.1, 0.9, 3).astype(np.float32)
MULTI_P = np.array([0.2, 0.3, 0.5], np.float32)


def _j(x):
    return paddle.to_tensor(x)


def _t(x):
    return torch.tensor(x)


# name -> (build(package, make), value to score or None)
CASES = {
    'Normal': (lambda D, m: D.Normal(m(LOC), m(SCALE)),
               R.randn(4, 3).astype(np.float32)),
    'Uniform': (lambda D, m: D.Uniform(m(LOW), m(HIGH)),
                np.stack([LOW - 0.1, (LOW + HIGH) / 2, HIGH])),
    'Categorical': (lambda D, m: D.Categorical(m(LOGITS)),
                    np.array([[0, 4], [3, 1], [2, 2]], np.int64)),
    'Beta': (lambda D, m: D.Beta(m(ALPHA), m(BETA)),
             R.uniform(0.05, 0.95, (2, 3)).astype(np.float32)),
    'Dirichlet': (lambda D, m: D.Dirichlet(m(CONC)),
                  R.dirichlet(np.ones(4), 2).astype(np.float32)),
    'Exponential': (lambda D, m: D.Exponential(m(RATE)),
                    R.uniform(0, 3, (2, 3)).astype(np.float32)),
    'Bernoulli': (lambda D, m: D.Bernoulli(m(PROBS)),
                  np.array([[0, 1, 1], [1, 0, 0]], np.float32)),
    'Multinomial': (lambda D, m: D.Multinomial(10, m(MULTI_P)), None),
}


SAMPLE_DTYPES = {'Categorical': torch.int64}


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               rtol=TOL, atol=TOL)


def _beta_lp(v):
    a, b = ALPHA.astype(np.float64), BETA.astype(np.float64)
    return (a - 1) * np.log(v) + (b - 1) * np.log1p(-v) - sp.betaln(a, b)


def _dirichlet_lp(v):
    a = CONC.astype(np.float64)
    return np.sum((a - 1) * np.log(v), -1) + sp.gammaln(a.sum(-1)) - \
        np.sum(sp.gammaln(a), -1)


def _beta_entropy():
    a, b = ALPHA.astype(np.float64), BETA.astype(np.float64)
    return sp.betaln(a, b) - (a - 1) * sp.digamma(a) - \
        (b - 1) * sp.digamma(b) + (a + b - 2) * sp.digamma(a + b)


# (name, method) -> the exact value in float64 (of the value scored)
EXACT = {
    ('Beta', 'log_prob'): _beta_lp,
    ('Beta', 'probs'): lambda v: np.exp(_beta_lp(v)),
    ('Beta', 'entropy'): lambda v: _beta_entropy(),
    ('Dirichlet', 'log_prob'): _dirichlet_lp,
    ('Dirichlet', 'probs'): lambda v: np.exp(_dirichlet_lp(v)),
}


def _check(name, method, got, want, value):
    """got (the port's) against want (the JAX package's): within TOL, or
    for the EXACT cases within TOL of the exact value and within TOL plus
    the JAX package's own error of want."""
    exact = EXACT.get((name, method))
    if exact is None:
        return _close(got, want)
    exact = exact(value.astype(np.float64) if value is not None else None)
    got, want = got.numpy().astype(np.float64), np.asarray(want.numpy())
    np.testing.assert_allclose(got, exact, rtol=TOL, atol=TOL)
    bound = TOL + TOL * np.abs(want) + np.abs(want - exact)
    assert (np.abs(got - want) <= bound).all(), (got, want, exact)


def _pair(name):
    build, value = CASES[name]
    return build(TD, _t), build(JD, _j), value


@pytest.mark.parametrize('name', sorted(CASES))
def test_scores_match_jax(name):
    t, j, value = _pair(name)
    checked = 0
    for method in ('log_prob', 'probs'):
        if value is None:
            with pytest.raises(NotImplementedError):
                getattr(t, method)(torch.zeros(3))
            continue
        if name == 'Categorical':
            # the JAX Categorical scores [batch]-shaped values per row
            vals = [value[i] for i in range(len(value))]
        else:
            vals = [value]
        for v in vals:
            _check(name, method, getattr(t, method)(_t(v)),
                   getattr(j, method)(_j(v)), v)
            checked += 1
    try:
        want = j.entropy()
    except NotImplementedError:
        with pytest.raises(NotImplementedError):
            t.entropy()
    else:
        _check(name, 'entropy', t.entropy(), want, None)
        checked += 1
    assert checked >= (0 if value is None else 2)


@pytest.mark.parametrize('name', ['Normal', 'Categorical'])
def test_kl_divergence_matches_jax(name):
    t, j, _ = _pair(name)
    if name == 'Normal':
        t2 = TD.Normal(_t(LOC[::-1].copy()), _t(SCALE * 1.5))
        j2 = JD.Normal(_j(LOC[::-1].copy()), _j(SCALE * 1.5))
    else:
        t2 = TD.Categorical(_t(LOGITS[::-1].copy()))
        j2 = JD.Categorical(_j(LOGITS[::-1].copy()))
    _close(TD.kl_divergence(t, t2), JD.kl_divergence(j, j2))
    _close(t.kl_divergence(t2), j.kl_divergence(j2))


@pytest.mark.parametrize('name', sorted(CASES))
def test_sample_shapes_and_dtypes_match_jax(name):
    t, j, _ = _pair(name)
    got = t.sample((4, 2), generator=torch.Generator().manual_seed(0))
    want = np.asarray(j.sample((4, 2)).numpy())
    assert tuple(got.shape) == want.shape
    assert got.dtype == SAMPLE_DTYPES.get(name, torch.float32)
    # the JAX Categorical asks for int64, which JAX gives as int32 with
    # 64-bit types off
    jax_dtype = str(got.dtype).split('.')[-1]
    if not jax.config.jax_enable_x64:
        jax_dtype = jax_dtype.replace('int64', 'int32')
    assert str(want.dtype) == jax_dtype


def _s(x):
    return torch.tensor(x, dtype=torch.float32)


def _moments(name):
    """Closed-form mean and variance of one scalar draw of `name` (each
    distribution built from scalars, so a draw is a scalar or a vector
    of its support)."""
    if name == 'Normal':
        return TD.Normal(_s(0.5), _s(2.0)), 0.5, 4.0
    if name == 'Uniform':
        return TD.Uniform(_s(-1.0), _s(3.0)), 1.0, 16.0 / 12
    if name == 'Categorical':
        logits = np.log(np.array([0.1, 0.2, 0.3, 0.4]))
        p = np.exp(logits)
        k = np.arange(4)
        mean = (k * p).sum()
        return (TD.Categorical(_t(logits.astype(np.float32))), mean,
                (k * k * p).sum() - mean ** 2)
    if name == 'Beta':
        a, b = 2.0, 3.0
        return TD.Beta(_s(a), _s(b)), a / (a + b), \
            a * b / ((a + b) ** 2 * (a + b + 1))
    if name == 'Dirichlet':
        a = np.array([1.0, 2.0, 3.0])
        a0 = a.sum()
        return (TD.Dirichlet(_t(a.astype(np.float32))), a / a0,
                a * (a0 - a) / (a0 ** 2 * (a0 + 1)))
    if name == 'Exponential':
        return TD.Exponential(_s(2.0)), 0.5, 0.25
    if name == 'Bernoulli':
        return TD.Bernoulli(_s(0.3)), 0.3, 0.21
    p = MULTI_P.astype(np.float64)
    return TD.Multinomial(10, _t(MULTI_P)), 10 * p, 10 * p * (1 - p)


def check_moments(x, mean, var, n_se=5.0):
    """The sample mean and variance of draws `x` [N, ...] within n_se
    standard errors of `mean` and `var` (the variance's standard error
    from the sample's fourth central moment). Returns the largest error
    in standard errors."""
    x = x.double()
    n = x.shape[0]
    m = x.mean(0)
    c = x - m
    v = (c ** 2).mean(0)
    m4 = (c ** 4).mean(0)
    mean = torch.as_tensor(mean, dtype=torch.float64, device=x.device)
    var = torch.as_tensor(var, dtype=torch.float64, device=x.device)
    z_mean = (m - mean).abs() / torch.sqrt(var / n)
    z_var = (v - var).abs() / torch.sqrt((m4 - v ** 2).clamp_min(1e-300) / n)
    worst = float(torch.maximum(z_mean, z_var).max())
    assert worst < n_se, (worst, m.tolist(), v.tolist())
    return worst


@pytest.mark.parametrize('name', sorted(CASES))
def test_draw_moments(name):
    dist, mean, var = _moments(name)
    x = dist.sample((DRAWS,), generator=torch.Generator().manual_seed(11))
    check_moments(x, mean, var)


@pytest.mark.parametrize('name', sorted(CASES))
def test_same_seed_same_draws(name):
    t, _, _ = _pair(name)
    # jax.random.dirichlet's shape includes the concentration's batch dims
    shape = (50, 2) if name == 'Dirichlet' else (50,)
    a = t.sample(shape, generator=torch.Generator().manual_seed(3))
    b = t.sample(shape, generator=torch.Generator().manual_seed(3))
    c = t.sample(shape, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # without a generator: the device's default generator, as dropout
    with torch.random.fork_rng():
        torch.manual_seed(5)
        d = t.sample(shape)
        torch.manual_seed(5)
        assert torch.equal(d, t.sample(shape))


def test_normal_sample_keeps_seed_parameter_and_rsample():
    t = TD.Normal(_t(LOC), _t(SCALE))
    g = torch.Generator().manual_seed(9)
    a = t.sample((3,), 123, generator=g)
    b = t.rsample((3,), generator=torch.Generator().manual_seed(9))
    assert torch.equal(a, b) and a.shape == (3, 3)


def test_scalar_parameters_take_the_current_device_and_default_dtype():
    from paddle_tpu_torch.framework import device as device_mod
    saved = dict(device_mod._STATE)
    try:
        device_mod.set_device('cpu')
        d = TD.Normal(0.0, 1.0)
        assert d.loc.device.type == 'cpu' and d.loc.dtype == torch.float32
        assert d.sample((2,)).dtype == torch.float32
        d64 = TD.Normal(_t(np.zeros(2)), _t(np.ones(2)))
        assert d64.sample((2,)).dtype == torch.float64
    finally:
        device_mod._STATE.update(saved)
