from . import clip, functional, initializer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .layer import (CrossEntropyLoss, Dropout, Embedding,  # noqa: F401
                    LayerNorm, Linear, ParamAttr, RMSNorm)
