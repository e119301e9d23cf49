"""Test-support utilities of the port (fault injection in
testing.chaos)."""
from . import chaos  # noqa: F401
