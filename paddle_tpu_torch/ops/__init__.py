from . import flash_attention, fused_ce  # noqa: F401
