from .optimizers import SGD, Adam, AdamW, Optimizer  # noqa: F401
