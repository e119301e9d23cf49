"""Loss layers (counterpart of paddle_tpu/nn/layer/loss.py): thin modules
over the loss functionals, with the reference's positional arguments in
its order. HSigmoidLoss holds its tree's internal-node table as
`weight` [num_classes - 1, feature_size] (num_classes rows when
is_custom) and `bias`, the JAX package's names, so a JAX state dict
carries across."""
from torch import nn

from ...framework import device as device_mod
from .. import functional as F
from .. import initializer as I
from .layers import create_parameter

__all__ = [
    'HSigmoidLoss', 'CrossEntropyLoss', 'MSELoss', 'L1Loss', 'NLLLoss',
    'BCELoss', 'BCEWithLogitsLoss', 'KLDivLoss', 'SmoothL1Loss',
    'MarginRankingLoss', 'CTCLoss', 'HingeEmbeddingLoss',
    'CosineEmbeddingLoss', 'TripletMarginLoss', 'SoftMarginLoss',
    'MultiLabelSoftMarginLoss']


class CrossEntropyLoss(nn.Module):
    def __init__(self, weight=None, ignore_index=-100, reduction='mean',
                 soft_label=False, axis=-1, use_softmax=True, name=None):
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


class MSELoss(nn.Module):
    def __init__(self, reduction='mean'):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self.reduction)


class L1Loss(nn.Module):
    def __init__(self, reduction='mean', name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self.reduction)


class NLLLoss(nn.Module):
    def __init__(self, weight=None, ignore_index=-100, reduction='mean',
                 name=None):
        super().__init__()
        self._weight = weight
        self._ignore_index = ignore_index
        self._reduction = reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, self._weight, self._ignore_index,
                          self._reduction)


class BCELoss(nn.Module):
    def __init__(self, weight=None, reduction='mean', name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self.weight,
                                      self.reduction)


class BCEWithLogitsLoss(nn.Module):
    def __init__(self, weight=None, reduction='mean', pos_weight=None,
                 name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.reduction, self.pos_weight)


class KLDivLoss(nn.Module):
    def __init__(self, reduction='mean'):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.kl_div(input, label, self.reduction)


class SmoothL1Loss(nn.Module):
    def __init__(self, reduction='mean', delta=1.0, name=None):
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self.reduction, self.delta)


class MarginRankingLoss(nn.Module):
    def __init__(self, margin=0.0, reduction='mean', name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self.margin,
                                     self.reduction)


class CTCLoss(nn.Module):
    def __init__(self, blank=0, reduction='mean'):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self.blank, self.reduction, norm_by_times)


class HingeEmbeddingLoss(nn.Module):
    def __init__(self, margin=1.0, reduction='mean', name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, self.margin,
                                      self.reduction)


class CosineEmbeddingLoss(nn.Module):
    def __init__(self, margin=0.0, reduction='mean', name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self.margin,
                                       self.reduction)


class TripletMarginLoss(nn.Module):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-06, swap=False,
                 reduction='mean', name=None):
        super().__init__()
        self.args = (margin, p, epsilon, swap, reduction)

    def forward(self, input, positive, negative):
        return F.triplet_margin_loss(input, positive, negative, *self.args)


class SoftMarginLoss(nn.Module):
    def __init__(self, reduction='mean', name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.soft_margin_loss(input, label, self.reduction)


class MultiLabelSoftMarginLoss(nn.Module):
    def __init__(self, weight=None, reduction='mean', name=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return F.multi_label_soft_margin_loss(input, label, self.weight,
                                              self.reduction)


class HSigmoidLoss(nn.Module):
    """Hierarchical sigmoid (reference nn.HSigmoidLoss): holds the
    internal-node weight / bias table; the default complete binary tree,
    or custom path tables at call time."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None, *, device=None, dtype='float32',
                 generator=None):
        super().__init__()
        if num_classes < 2:
            raise ValueError('num_classes must be >= 2')
        self._num_classes = num_classes
        self._is_custom = is_custom
        n_nodes = num_classes - 1 if not is_custom else num_classes
        dev = device_mod.resolve(device)
        self.weight = create_parameter([n_nodes, feature_size], weight_attr,
                                       dtype, I.XavierNormal(), generator,
                                       dev)
        self.bias = create_parameter([n_nodes], bias_attr, dtype,
                                     I.Constant(0.0), generator, dev)

    def forward(self, input, label, path_table=None, path_code=None):
        return F.hsigmoid_loss(input, label, self._num_classes,
                               self.weight, self.bias,
                               path_table=path_table, path_code=path_code)
