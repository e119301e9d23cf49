"""fleet.utils (counterpart of paddle_tpu/distributed/fleet/utils.py):
activation recompute.

`recompute(function, *args)` runs function(*args) under
torch.utils.checkpoint (non-reentrant): the forward keeps only the inputs,
and the backward runs the function again to rebuild what it needs. The
parameters a Module uses get their gradients, as in the JAX package, where
they enter the checkpoint as explicit inputs. The recompute draws the
forward's random numbers again (torch's default generators restored,
preserve_rng_state=True by default) and casts under the auto_cast state
the forward had. The file-system clients of the JAX module are not
ported.
"""
from torch.utils.checkpoint import checkpoint

from ...amp.auto_cast import amp_state, restore_state

__all__ = ['recompute']


def recompute(function, *args, **kwargs):
    preserve = kwargs.pop('preserve_rng_state', True)
    state = dict(amp_state())

    def run(*inputs):
        with restore_state(state):
            return function(*inputs, **kwargs)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=preserve)
