from . import device, dtype, functional, random  # noqa: F401
