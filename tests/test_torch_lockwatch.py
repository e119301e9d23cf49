"""The port's runtime lock-order witness (paddle_tpu_torch/testing/
lockwatch.py) against the JAX package's, on the CPU: the same
acquisition sequences, across threads, give equal edge graphs, the same
cycle verdicts (with and without static edges) and the same strict-mode
raises; wrapped Conditions still wait and notify."""
import threading

import pytest

from paddle_tpu.testing import lockwatch as jlw
from paddle_tpu_torch.testing import lockwatch as tlw


def _drive(mod, strict=False, invert=False):
    watch = mod.LockWatch(strict=strict)
    a = watch.wrap('a', threading.Lock())
    b = watch.wrap('b', threading.RLock())
    cv = watch.wrap('cv', threading.Condition())
    out = []

    def one():
        with a:
            with b:
                with b:             # re-entrant: no self edge
                    pass
        with cv:
            cv.notify_all()

    def two():
        try:
            with (b if invert else a):
                with (a if invert else cv):
                    pass
        except mod.LockOrderError as e:
            out.append(type(e).__name__)

    for fn in (one, two):
        t = threading.Thread(target=fn)
        t.start()
        t.join()
    return watch, out


@pytest.mark.parametrize('invert', [False, True])
def test_edges_and_verdicts_equal_jax(invert):
    res = []
    for mod in (jlw, tlw):
        watch, _ = _drive(mod, invert=invert)
        verdicts = []
        for extra in ((), [('cv', 'a')], [('b', 'cv')]):
            try:
                watch.assert_acyclic(extra)
                verdicts.append('ok')
            except mod.LockOrderError as e:
                verdicts.append(str(e))
        res.append((watch.edges(), verdicts))
    assert res[1] == res[0]
    assert ('a', 'b') in res[1][0]
    assert (res[1][1][0] == 'ok') != invert


def test_strict_raises_at_the_inverting_acquire_like_jax():
    outs = [_drive(mod, strict=True, invert=True)[1] for mod in (jlw, tlw)]
    assert outs[0] == outs[1] == ['LockOrderError']


def test_wrapped_condition_waits_and_notifies():
    watch = tlw.LockWatch()
    cv = watch.wrap('cv', threading.Condition())
    seen = []

    def waiter():
        with cv:
            cv.wait_for(lambda: seen, timeout=10)

    t = threading.Thread(target=waiter)
    t.start()
    with cv:
        seen.append(1)
        cv.notify_all()
    t.join(10)
    assert not t.is_alive() and watch.edges() == {}
