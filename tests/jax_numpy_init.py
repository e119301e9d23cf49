"""A pytest fixture for the port's parity tests: the JAX package's layer
initializers (Uniform, Constant, XavierNormal) drawn by numpy from one
seed while a test runs.

The tests build a JAX layer and carry its weights to the port, so where
the draws come from does not matter to them; jax.random would compile a
kernel for every parameter shape, which is most of the time a test of a
model spends. Import the fixture into a test module to use it:
`from jax_numpy_init import numpy_init  # noqa: F401`; a fixture of
wider scope calls `install` on a `pytest.MonkeyPatch` of its own.
"""
import numpy as np
import pytest


def install(monkeypatch):
    """Patch the initializers on `monkeypatch` to draw from one numpy
    RandomState seeded with 0."""
    import jax.numpy as jnp
    import paddle_tpu.nn.initializer as I
    from paddle_tpu.framework.dtype import to_jax_dtype
    rng = np.random.RandomState(0)

    def draw(self, shape, dtype='float32'):
        shape = tuple(shape)
        if isinstance(self, I.Uniform):
            a = rng.uniform(self.low, self.high, shape)
        elif isinstance(self, I.Constant):
            a = np.full(shape, self.value)
        else:
            fi, fo = I._fans(shape)
            a = rng.standard_normal(shape) * np.sqrt(2.0 / (fi + fo))
        return jnp.asarray(a.astype(np.float32)).astype(to_jax_dtype(dtype))
    for cls in (I.Uniform, I.Constant, I.XavierNormal):
        monkeypatch.setattr(cls, '__call__', draw)


@pytest.fixture
def numpy_init(monkeypatch):
    install(monkeypatch)
