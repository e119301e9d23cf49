"""Distance layers (counterpart of paddle_tpu/nn/layer/distance.py)."""
import torch
from torch import nn

from ...amp.auto_cast import cast as amp_cast

__all__ = ['PairwiseDistance', 'pairwise_distance']


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False):
    """The p-norm of x - y along the last axis, epsilon added to each
    |x - y| first (the JAX package's PairwiseDistance arithmetic)."""
    x, y = amp_cast('pairwise_distance', x, y)
    d = torch.abs(x - y) + epsilon
    return torch.pow(torch.sum(torch.pow(d, p), dim=-1, keepdim=keepdim),
                     1.0 / p)


class PairwiseDistance(nn.Module):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)
