"""Loss layers (counterpart of paddle_tpu/nn/layer/loss.py): the
CrossEntropyLoss that training configures."""
from torch import nn

from .. import functional as F

__all__ = ['CrossEntropyLoss']


class CrossEntropyLoss(nn.Module):
    def __init__(self, weight=None, ignore_index=-100, reduction='mean',
                 soft_label=False, axis=-1, use_softmax=True):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax

    def forward(self, input, label):
        return F.cross_entropy(input, label, weight=self.weight,
                               ignore_index=self.ignore_index,
                               reduction=self.reduction,
                               soft_label=self.soft_label, axis=self.axis,
                               use_softmax=self.use_softmax)
