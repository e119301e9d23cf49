from .common import Dropout, Embedding, Linear  # noqa: F401
from .layers import ParamAttr  # noqa: F401
from .loss import CrossEntropyLoss  # noqa: F401
from .norm import LayerNorm, RMSNorm  # noqa: F401
