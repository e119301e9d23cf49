from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .container import *  # noqa: F401,F403
from .distance import PairwiseDistance  # noqa: F401
from .layers import ParamAttr  # noqa: F401
from .loss import *  # noqa: F401,F403
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D,  # noqa: F401
                   BatchNorm3D, GroupNorm, InstanceNorm1D, InstanceNorm2D,
                   InstanceNorm3D, LayerNorm, LocalResponseNorm, RMSNorm,
                   SpectralNorm, SyncBatchNorm)
from .transformer import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
