from . import clip, functional, initializer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .layer import *  # noqa: F401,F403
from .layer import (CrossEntropyLoss, Dropout, Embedding,  # noqa: F401
                    LayerNorm, Linear, PairwiseDistance, ParamAttr, RMSNorm)
from .layer import (BatchNorm, BatchNorm1D, BatchNorm2D,  # noqa: F401
                    BatchNorm3D, GroupNorm, InstanceNorm1D, InstanceNorm2D,
                    InstanceNorm3D, LocalResponseNorm, SpectralNorm,
                    SyncBatchNorm)
from .utils_weight_norm import (remove_spectral_norm,  # noqa: F401
                                remove_weight_norm, spectral_norm,
                                weight_norm)
from .decode import BeamSearchDecoder, dynamic_decode  # noqa: F401
from . import quant  # noqa: F401


class utils:
    """paddle.nn.utils: the weight and spectral norms, the grad clips and
    the parameter / vector conversions."""
    from .utils_weight_norm import (remove_spectral_norm, remove_weight_norm,
                                    spectral_norm, weight_norm)
    from .clip import clip_grad_norm_, clip_grad_value_

    @staticmethod
    def parameters_to_vector(parameters, name=None):
        import torch
        return torch.cat([p.reshape(-1) for p in parameters])

    @staticmethod
    def vector_to_parameters(vec, parameters, name=None):
        import torch
        offset = 0
        with torch.no_grad():
            for p in parameters:
                n = p.numel()
                p.copy_(vec[offset:offset + n].reshape(p.shape))
                offset += n
