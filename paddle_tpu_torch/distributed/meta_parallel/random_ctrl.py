"""Megatron-style RNG state isolation (counterpart of
paddle_tpu/distributed/meta_parallel/random_ctrl.py; reference:
fleet/meta_parallel/parallel_layers/random.py:24 RNGStatesTracker).

A tracked state is a torch generator state, keyed by name. Inside
`rng_state(name)` the default generators draw from it (torch's CPU
generator, and the current card's when CUDA is up); on exit the state
advances and the defaults are restored. 'global' draws must agree across
mp ranks and 'local' ones differ: model_parallel_random_seed seeds the
global stream with `seed` on every rank and the tracked
'model_parallel_rng' with seed + 1024 + the rank's mp index (the JAX
package folds the index in under its multi-controller note; its one
process has index 0).
"""
import contextlib

import torch

MODEL_PARALLEL_RNG = 'model_parallel_rng'

__all__ = ['RNGStatesTracker', 'get_rng_state_tracker',
           'model_parallel_random_seed', 'MODEL_PARALLEL_RNG']


def _states_of(seed):
    cpu = torch.Generator(device='cpu').manual_seed(int(seed)).get_state()
    cuda = None
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        g = torch.Generator(device='cuda').manual_seed(int(seed))
        cuda = g.get_state()
    return {'cpu': cpu, 'cuda': cuda}


class RNGStatesTracker:
    def __init__(self):
        self.states_ = {}
        self.seeds_ = set()

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()

    def add(self, name, seed):
        if seed in self.seeds_:
            raise ValueError('seed %s already exists' % seed)
        self.seeds_.add(seed)
        if name in self.states_:
            raise ValueError('state %s already exists' % name)
        self.states_[name] = _states_of(seed)

    def get_states_tracker(self):
        return dict(self.states_)

    def set_states_tracker(self, states):
        self.states_ = dict(states)

    @contextlib.contextmanager
    def rng_state(self, name=MODEL_PARALLEL_RNG):
        if name not in self.states_:
            raise ValueError('state %s does not exist' % name)
        state = self.states_[name]
        orig_cpu = torch.get_rng_state()
        use_cuda = state['cuda'] is not None and torch.cuda.is_initialized()
        orig_cuda = torch.cuda.get_rng_state() if use_cuda else None
        torch.set_rng_state(state['cpu'])
        if use_cuda:
            torch.cuda.set_rng_state(state['cuda'])
        try:
            yield
        finally:
            state['cpu'] = torch.get_rng_state()
            torch.set_rng_state(orig_cpu)
            if use_cuda:
                state['cuda'] = torch.cuda.get_rng_state()
                torch.cuda.set_rng_state(orig_cuda)


_RNG_STATE_TRACKER = RNGStatesTracker()


def get_rng_state_tracker():
    return _RNG_STATE_TRACKER


def model_parallel_random_seed(seed=None):
    import random as pyrandom
    from ..topology import get_hybrid_communicate_group
    seed = seed or (pyrandom.getrandbits(32))
    hcg = get_hybrid_communicate_group()
    mp_rank = hcg.get_model_parallel_rank() if hcg is not None else 0
    global_seed = seed
    local_seed = seed + 1024 + mp_rank
    _RNG_STATE_TRACKER.reset()
    _RNG_STATE_TRACKER.add(MODEL_PARALLEL_RNG, local_seed)
    torch.manual_seed(global_seed)
