from . import functional, initializer  # noqa: F401
from .layer import Dropout, Embedding, LayerNorm, Linear, RMSNorm  # noqa: F401
