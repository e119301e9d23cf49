"""The port's learning-rate schedulers (paddle_tpu_torch/optimizer/lr.py)
against the JAX package's: all fifteen, stepped 60 times, set to an epoch
with step(epoch), and carried through state_dict / set_state_dict."""
import math

import pytest

from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.optimizer import lr as tlr

STEPS = 60


def _cases(m):
    return {
        'noam': lambda: m.NoamDecay(64, 10, learning_rate=2.0),
        'piecewise': lambda: m.PiecewiseDecay([10, 30], [0.1, 0.05, 0.01]),
        'natural_exp': lambda: m.NaturalExpDecay(0.1, 0.05),
        'inverse_time': lambda: m.InverseTimeDecay(0.1, 0.1),
        'polynomial': lambda: m.PolynomialDecay(0.1, 20, end_lr=0.001,
                                                power=2.0),
        'polynomial_cycle': lambda: m.PolynomialDecay(0.1, 20, cycle=True),
        'linear_warmup_cosine': lambda: m.LinearWarmup(
            m.CosineAnnealingDecay(6e-4, 40, eta_min=6e-5), 10, 0.0, 6e-4),
        'linear_warmup_float': lambda: m.LinearWarmup(0.1, 10, 0.01, 0.1),
        'exponential': lambda: m.ExponentialDecay(0.1, 0.9),
        'multi_step': lambda: m.MultiStepDecay(0.1, [10, 25, 40]),
        'step': lambda: m.StepDecay(0.1, 7, gamma=0.5),
        'lambda': lambda: m.LambdaDecay(0.1, lambda e: 0.95 ** e),
        'multiplicative': lambda: m.MultiplicativeDecay(0.1,
                                                        lambda e: 0.97),
        'cosine': lambda: m.CosineAnnealingDecay(0.1, 20, eta_min=0.001),
        'reduce_on_plateau': lambda: m.ReduceOnPlateau(
            0.1, patience=2, cooldown=1, factor=0.5),
        'one_cycle': lambda: m.OneCycleLR(0.1, STEPS),
        'one_cycle_linear': lambda: m.OneCycleLR(
            0.1, STEPS, anneal_strategy='linear'),
        'cyclic_triangular2': lambda: m.CyclicLR(0.01, 0.1, 8,
                                                 mode='triangular2'),
        'cyclic_exp_range': lambda: m.CyclicLR(0.01, 0.1, 5, 9,
                                               mode='exp_range',
                                               exp_gamma=0.97),
    }


def _metric(i):
    # a loss that falls, stalls, then falls again
    return 2.0 - 0.1 * min(i, 10) - 0.05 * max(i - 30, 0)


def _step(s, i):
    if isinstance(s, (jlr.ReduceOnPlateau, tlr.ReduceOnPlateau)):
        s.step(_metric(i))
    else:
        s.step()


def test_every_scheduler_is_ported():
    assert set(jlr.__all__) == set(tlr.__all__)
    classes = {type(make()).__name__ for make in _cases(tlr).values()}
    assert classes | {'LRScheduler'} == set(tlr.__all__)


@pytest.mark.parametrize('case', sorted(_cases(tlr)))
def test_scheduler_matches_jax(case):
    want_s, got_s = _cases(jlr)[case](), _cases(tlr)[case]()
    for i in range(STEPS):
        want, got = want_s(), got_s()
        assert math.isclose(got, want, rel_tol=1e-12, abs_tol=1e-12), \
            (case, i, got, want)
        _step(want_s, i)
        _step(got_s, i)
    # step(epoch) sets the epoch rather than advancing it
    if case != 'reduce_on_plateau':
        want_s.step(17)
        got_s.step(17)
        assert math.isclose(got_s(), want_s(), rel_tol=1e-12, abs_tol=1e-12)
        assert got_s.last_epoch == want_s.last_epoch == 17
    # a state round trip resumes the schedule where it was
    state = got_s.state_dict()
    assert state == want_s.state_dict()
    fresh = _cases(tlr)[case]()
    fresh.set_state_dict(state)
    assert fresh() == got_s()
    # (ReduceOnPlateau's state is its last epoch and rate only, in both
    # packages: its best metric and patience counters start afresh)
    for i in range(0 if case == 'reduce_on_plateau' else 5):
        assert math.isclose(fresh(), got_s(), rel_tol=1e-12, abs_tol=1e-12)
        _step(fresh, 40 + i)
        _step(got_s, 40 + i)
