"""Step timeline (counterpart of paddle_tpu/monitor/perf/): StepTimeline
splits each decode burst into host dispatch and the wait for the card. The
CompileWatchdog and the XLA cost model have no counterpart: eager PyTorch
compiles nothing, and the cost model reads XLA's analysis."""
from .timeline import PHASES, StepTimeline

__all__ = ['StepTimeline', 'PHASES']
