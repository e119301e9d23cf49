"""Seeded generators and the RNG state (counterpart of
paddle_tpu/framework/random.py).

The JAX package threads PRNG keys through one global Generator; the port
draws from explicit torch.Generators instead. `seed(s)` returns a new CPU
generator: weights are drawn on the CPU and then moved, so one seed gives
the same weights on every device. JAX's threefry and torch's generators
give different numbers from the same seed, so parity tests carry weights
across with load_paddle_tpu_state rather than reseeding.

`get_rng_state` / `set_rng_state` capture and restore the streams that
draws without an explicit generator consume: torch's default CPU
generator and, once CUDA is initialised, every device's default CUDA
generator (dropout with generator=None on the card draws from it). A
resume that restored only the CPU state would not be exact.
"""
import torch


def seed(s):
    """A CPU torch.Generator seeded with `s`."""
    return torch.Generator(device='cpu').manual_seed(int(s))


def get_rng_state():
    """{'cpu': ByteTensor, 'cuda': [ByteTensor per device] or None}."""
    cuda = torch.cuda.get_rng_state_all() \
        if torch.cuda.is_initialized() else None
    return {'cpu': torch.get_rng_state(), 'cuda': cuda}


def set_rng_state(state):
    """Restore what get_rng_state returned."""
    torch.set_rng_state(state['cpu'])
    if state.get('cuda') is not None:
        torch.cuda.set_rng_state_all(state['cuda'])


def manual_seed(s):
    """Seed torch's default generators (the CPU one and every CUDA
    device's), the streams that draws without an explicit generator
    consume; returns the CPU one (the top-level `seed`, Paddle's
    paddle.seed)."""
    return torch.manual_seed(int(s))
