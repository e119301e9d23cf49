"""Test-support utilities of the port (fault injection in testing.chaos,
runtime lock-order witnessing in testing.lockwatch)."""
from . import chaos  # noqa: F401
from . import lockwatch  # noqa: F401
