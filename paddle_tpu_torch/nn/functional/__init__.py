from .activation import *  # noqa: F401,F403
from .activation import softmax_  # noqa: F401
from .attention import scaled_dot_product_attention  # noqa: F401
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .extension import (gather_tree, temporal_shift,  # noqa: F401
                        sequence_mask, diag_embed, affine_grid,
                        grid_sample, hsigmoid_loss)
from .norm import (batch_norm, group_norm, instance_norm,  # noqa: F401
                   layer_norm, local_response_norm, normalize, rms_norm)
from .sparse_attention import sparse_attention  # noqa: F401
