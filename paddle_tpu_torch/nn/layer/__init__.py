from .activation import *  # noqa: F401,F403
from .common import Dropout, Embedding, Linear  # noqa: F401
from .container import *  # noqa: F401,F403
from .distance import PairwiseDistance  # noqa: F401
from .layers import ParamAttr  # noqa: F401
from .loss import CrossEntropyLoss  # noqa: F401
from .norm import LayerNorm, RMSNorm  # noqa: F401
from .transformer import *  # noqa: F401,F403
