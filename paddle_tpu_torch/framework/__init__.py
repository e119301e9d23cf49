from . import device, dtype, random  # noqa: F401
