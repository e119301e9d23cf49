"""Seeded generators (counterpart of paddle_tpu/framework/random.py).

The JAX package threads PRNG keys through one global Generator; the port
draws from explicit torch.Generators instead. `seed(s)` returns a new CPU
generator: weights are drawn on the CPU and then moved, so one seed gives
the same weights on every device. JAX's threefry and torch's generators
give different numbers from the same seed, so parity tests carry weights
across with load_paddle_tpu_state rather than reseeding.
"""
import torch


def seed(s):
    """A CPU torch.Generator seeded with `s`."""
    return torch.Generator(device='cpu').manual_seed(int(s))
