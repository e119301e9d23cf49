"""paddle.text parity (counterpart of paddle_tpu/text/): the NLP datasets
and the transformer model zoo the benchmarks use."""
from . import datasets  # noqa: F401
from . import models  # noqa: F401
from .datasets import *  # noqa: F401,F403
