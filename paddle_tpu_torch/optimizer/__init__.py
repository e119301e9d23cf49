from . import lr  # noqa: F401
from .optimizers import (SGD, Adadelta, Adagrad, Adam, Adamax,  # noqa: F401
                         AdamW, Dpsgd, Ftrl, Lamb, LarsMomentum, Momentum,
                         Optimizer, ProximalAdagrad, ProximalGD, RMSProp,
                         SparseAdam)
