from . import blockwise_attention, flash_attention, fused_ce  # noqa: F401
