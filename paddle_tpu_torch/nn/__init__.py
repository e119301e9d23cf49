from . import clip, functional, initializer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .layer import *  # noqa: F401,F403
from .layer import (CrossEntropyLoss, Dropout, Embedding,  # noqa: F401
                    LayerNorm, Linear, PairwiseDistance, ParamAttr, RMSNorm)
