"""Performance introspection (counterpart of paddle_tpu/monitor/perf/).

Three components, each usable alone:

- ``watchdog``  — CompileWatchdog: TorchDynamo compile callbacks,
  recompile attribution (callsite + input signature), warmup barrier
  with flight dump + optional strict hard-fail;
- ``timeline``  — StepTimeline: data-wait / host-dispatch /
  device-block phase split with rolling percentiles and straggler
  detection;
- ``costmodel`` — FLOPs (torch.utils.flop_counter on fake tensors, with
  formulas for the port's custom ops) and bytes of a step -> arithmetic
  intensity, roofline bound, ideal step time and MFU against the card's
  datasheet peaks.

All metric families are single-sourced in
``monitor.telemetry.PERF_FAMILIES`` (registered via
``record_perf_schema``).
"""
from . import costmodel
from .timeline import PHASES, StepTimeline
from .watchdog import COMPILE_EVENTS, CompileWatchdog, RecompileError

__all__ = ['CompileWatchdog', 'RecompileError', 'COMPILE_EVENTS',
           'StepTimeline', 'PHASES', 'costmodel']
