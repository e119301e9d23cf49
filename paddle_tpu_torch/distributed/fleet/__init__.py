"""fleet (counterpart of paddle_tpu/distributed/fleet/): `recompute` only.
The fleet's strategies and its hybrid-parallel steps come with the
distributed slice."""
from .utils import recompute  # noqa: F401
