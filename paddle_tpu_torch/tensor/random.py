"""Random sampling (counterpart of paddle_tpu/tensor/random.py).

Every function takes, keyword-only, the `generator` it draws from (a
torch.Generator on the result's device; torch's default generator of that
device when None) and the `device` of a new tensor (the current device
when None). `seed` != 0 draws from a fresh generator seeded with it, a
draw independent of any stream, as the JAX package's PRNGKey(seed) is.
JAX's threefry bits cannot be reproduced, so draws are compared with the
JAX package's by their distributions.
"""
import torch

from ._helpers import default_float, ensure_tensor, shape_arg, tdt
from ..framework import device as device_mod

__all__ = [
    'check_shape',
    'rand', 'randn', 'randint', 'randint_like', 'randperm', 'uniform',
    'normal', 'standard_normal', 'bernoulli', 'multinomial', 'poisson',
    'uniform_', 'normal_', 'exponential_',
]


def _dtype(dtype):
    return tdt(dtype) if dtype is not None else default_float()


def _gen(generator, device, seed=0):
    if seed:
        return torch.Generator(device=device).manual_seed(int(seed))
    if generator is not None:
        return generator
    if device.type == 'cuda':
        return torch.cuda.default_generators[
            device.index if device.index is not None
            else torch.cuda.current_device()]
    return torch.default_generator


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None, *,
            generator=None, device=None):
    dev = device_mod.resolve(device)
    out = torch.empty(shape_arg(shape), dtype=_dtype(dtype), device=dev)
    return out.uniform_(min, max, generator=_gen(generator, dev, seed))


def rand(shape, dtype=None, name=None, *, generator=None, device=None):
    return uniform(shape, dtype, 0.0, 1.0, generator=generator,
                   device=device)


def randn(shape, dtype=None, name=None, *, generator=None, device=None):
    dev = device_mod.resolve(device)
    return torch.randn(shape_arg(shape), dtype=_dtype(dtype), device=dev,
                       generator=_gen(generator, dev))


standard_normal = randn


def normal(mean=0.0, std=1.0, shape=None, name=None, *, generator=None,
           device=None):
    """mean + std * N(0, 1); with a tensor mean or std, of their broadcast
    shape (f32), else of `shape` in the default dtype."""
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        like = mean if isinstance(mean, torch.Tensor) else std
        m, s = ensure_tensor(mean, like), ensure_tensor(std, like)
        shp = torch.broadcast_shapes(m.shape, s.shape)
        z = torch.randn(shp, dtype=torch.float32, device=like.device,
                        generator=_gen(generator, like.device))
        return m + s * z
    return mean + std * randn(() if shape is None else shape,
                              generator=generator, device=device)


def randint(low=0, high=None, shape=(1,), dtype='int64', name=None, *,
            generator=None, device=None):
    if high is None:
        low, high = 0, low
    dev = device_mod.resolve(device)
    return torch.randint(low, high, shape_arg(shape), dtype=tdt(dtype),
                         device=dev, generator=_gen(generator, dev))


def randint_like(x, low=0, high=None, dtype=None, name=None, *,
                 generator=None):
    x = ensure_tensor(x)
    return randint(low, high, x.shape, dtype or x.dtype, generator=generator,
                   device=x.device)


def randperm(n, dtype='int64', name=None, *, generator=None, device=None):
    dev = device_mod.resolve(device)
    return torch.randperm(n, dtype=tdt(dtype), device=dev,
                          generator=_gen(generator, dev))


def bernoulli(x, name=None, *, generator=None):
    x = ensure_tensor(x)
    return torch.bernoulli(x, generator=_gen(generator, x.device))


def multinomial(x, num_samples=1, replacement=False, name=None, *,
                generator=None):
    x = ensure_tensor(x)
    return torch.multinomial(x, num_samples, replacement,
                             generator=_gen(generator, x.device))


def poisson(x, name=None, *, generator=None):
    x = ensure_tensor(x)
    return torch.poisson(x, generator=_gen(generator, x.device))


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None, *, generator=None):
    """x filled in place from U[min, max); returns x."""
    with torch.no_grad():
        return x.uniform_(min, max, generator=_gen(generator, x.device,
                                                   seed))


def normal_(x, mean=0.0, std=1.0, name=None, *, generator=None):
    with torch.no_grad():
        return x.normal_(mean, std, generator=_gen(generator, x.device))


def exponential_(x, lam=1.0, name=None, *, generator=None):
    with torch.no_grad():
        return x.exponential_(lam, generator=_gen(generator, x.device))


def check_shape(shape, op_name='check_shape'):
    """Validate a shape argument: a list or tuple of ints (at most one -1)
    or an integer tensor."""
    if isinstance(shape, torch.Tensor):
        if shape.is_floating_point() or shape.is_complex():
            raise TypeError('%s: shape tensor must be int32/int64' % op_name)
        return
    if not isinstance(shape, (list, tuple)):
        raise TypeError('%s: shape must be a list/tuple/Tensor, got %r'
                        % (op_name, type(shape)))
    negs = 0
    for s in shape:
        if isinstance(s, torch.Tensor):
            continue
        if int(s) < -1:
            raise ValueError('%s: shape dims must be >= -1' % op_name)
        negs += int(s) == -1
    if negs > 1:
        raise ValueError('%s: at most one dim may be -1' % op_name)
