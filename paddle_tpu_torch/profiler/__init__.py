"""Profiler (counterpart of paddle_tpu/profiler/; reference:
paddle/fluid/platform/profiler.h RecordEvent +
python/paddle/fluid/profiler.py).

torch.profiler (CUPTI on the card) stands where the JAX package uses
jax.profiler: `Profiler` / `profiler` / `start_profiler` record CPU
activity, and CUDA activity whenever the card is there, and write a
Chrome trace (`*.pt.trace.json`) into their log dir when they stop.
On the card a trace that caught no device activity raises: a profile
that silently dropped to CPU-only activity would read as an idle card.
On an H100 under torch 2.11 a trace can lose the first launches of its
recording window (7-13 launches within ~2 ms, some traces in ten;
cupti_probe.py), with or without a traced warm-up step. So with CUDA
activity on, the window opens on a pad: PAD_LAUNCHES short device sleeps
(`spin_kernel` in the trace, ~20 ms of device time), which take that
loss in place of the user's launches. `scheduler=(start, end)` traces
step `start - 1` as a warm-up and records steps [start, end), each ended
by `Profiler.step()`.
`RecordEvent` is dual-sink: a torch.profiler.record_function region in
the trace and a span of the tracer (so the same region shows up in
Perfetto next to the kernels and in the flight recorder / /debug/traces
view). `merge_traces` folds per-rank trace dirs into one timeline with
per-rank lanes, the JAX package's layout.
"""
import contextlib
import os
import tempfile
import time

import torch

from ..monitor import tracing as _tracing

__all__ = ['RecordEvent', 'profiler', 'start_profiler', 'stop_profiler',
           'Profiler', 'ProfilerTarget', 'ProfilerState',
           'export_chrome_tracing', 'load_profiler_result', 'merge_traces']


def _default_dir():
    return os.path.join(tempfile.gettempdir(), 'paddle_tpu_torch_profile')


class RecordEvent:
    """RAII trace annotation (platform/profiler.h:127 parity).

    Dual-sink: the name lands in the profiler's trace as a
    torch.profiler.record_function region AND in the host tracer as a
    span."""

    def __init__(self, name, event_type=None):
        self.name = name
        self._ctx = None
        self._span = None

    def __enter__(self):
        self._span = _tracing.default_tracer().start_span(self.name)
        self._span.__enter__()
        self._ctx = torch.profiler.record_function(self.name)
        self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        self._ctx.__exit__(*(exc or (None, None, None)))
        if self._span is not None:
            self._span.__exit__(*(exc or (None, None, None)))
            self._span = None
        return False

    def begin(self):
        self.__enter__()

    def end(self):
        self.__exit__(None, None, None)


class ProfilerTarget:
    CPU = 'cpu'
    GPU = 'gpu'
    TPU = 'tpu'


class ProfilerState:
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


def _activities(targets):
    """torch.profiler activities for `targets` (None: CPU, and CUDA when
    the card is there). Asking for the GPU without one raises."""
    from torch.profiler import ProfilerActivity
    if targets is None:
        targets = [ProfilerTarget.CPU]
        if torch.cuda.is_available():
            targets.append(ProfilerTarget.GPU)
    acts = []
    for t in targets:
        if t == ProfilerTarget.CPU:
            acts.append(ProfilerActivity.CPU)
        elif t == ProfilerTarget.GPU:
            if not torch.cuda.is_available():
                raise RuntimeError('ProfilerTarget.GPU asked for, but CUDA '
                                   'is not available')
            acts.append(ProfilerActivity.CUDA)
        else:
            raise ValueError('no %r profiler target in the port (CPU and '
                             'GPU)' % (t,))
    return acts


def _schedule(scheduler):
    """A torch.profiler schedule from Paddle's `scheduler`: None (record
    everything), a (start, end) step range (warm-up at start - 1, once),
    or a torch schedule callable as it is."""
    if scheduler is None or callable(scheduler):
        return scheduler
    start, end = (int(x) for x in scheduler)
    if not 0 <= start < end:
        raise ValueError('scheduler=(start, end) needs 0 <= start < end, '
                         'got %r' % (scheduler,))
    return torch.profiler.schedule(wait=max(start - 1, 0),
                                   warmup=min(start, 1),
                                   active=end - start, repeat=1)


# the pad that opens a recording window with CUDA activity on: launches
# of torch.cuda._sleep of PAD_CYCLES cycles each (~0.3 ms at 1.98 GHz)
PAD_LAUNCHES, PAD_CYCLES = 64, 600_000


def _recording(prof):
    from torch.profiler import ProfilerAction
    return prof.current_action in (ProfilerAction.RECORD,
                                   ProfilerAction.RECORD_AND_SAVE)


def pad_window():
    """Launch the pad that opens a recording window: for code that
    drives torch.profiler.profile itself (leave `spin_kernel` out of its
    kernel sums)."""
    for _ in range(PAD_LAUNCHES):
        torch.cuda._sleep(PAD_CYCLES)


def _device_events(prof):
    """Events of the trace that ran on the card."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events() if e.device_type == cuda]


class Profiler:
    """paddle.profiler.Profiler-style context over torch.profiler.

    On stop the trace is written to
    ``<log_dir>/<worker>.<pid>.pt.trace.json`` (Chrome trace format),
    ready for merge_traces; ``events()`` and ``key_averages()`` read it
    in process."""

    def __init__(self, targets=None, scheduler=None,
                 on_trace_ready=None, timer_only=False,
                 log_dir=None, worker_name=None):
        # launcher/spawn seat a per-rank trace dir so a distributed run's
        # traces land rank-separated, ready for merge_traces
        self.log_dir = (log_dir
                        or os.environ.get('PADDLE_TRAINER_TRACE_DIR')
                        or _default_dir())
        self.worker_name = worker_name or 'host'
        self.timer_only = timer_only
        self._targets = targets
        self._scheduler = scheduler
        self._on_trace_ready = on_trace_ready
        self._times = []
        self._t0 = None
        self._prof = None         # a torch.profiler run in progress
        self.trace_path = None
        self.last = None          # the finished torch.profiler.profile

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def start(self):
        self._t0 = time.time()
        if self.timer_only:
            return
        acts = _activities(self._targets)
        # the handler may redirect log_dir (export_chrome_tracing), so it
        # must run BEFORE the trace starts
        if self._on_trace_ready is not None:
            self._on_trace_ready(self)
        prof = torch.profiler.profile(activities=acts,
                                      schedule=_schedule(self._scheduler))
        prof.__enter__()
        self._prof = prof
        self._cuda = torch.profiler.ProfilerActivity.CUDA in acts
        if self._cuda and _recording(prof):
            pad_window()

    def stop(self):
        # only stop a trace this profiler actually started: stop()
        # without start(), after a failed start(), or called twice must
        # not raise (and must not end someone else's trace)
        prof, self._prof = self._prof, None
        if prof is None:
            return
        if self._cuda:
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        self.last = prof
        os.makedirs(self.log_dir, exist_ok=True)
        self.trace_path = os.path.join(
            self.log_dir, '%s.%d.%d.pt.trace.json'
            % (self.worker_name, os.getpid(), int(time.time() * 1e3)))
        prof.export_chrome_trace(self.trace_path)
        if self._cuda and not _device_events(prof):
            raise RuntimeError(
                'the profiler asked for CUDA activity and its trace holds '
                'none (CUPTI recorded no kernel): the device profile is '
                'missing, not idle')

    def events(self):
        return self.last.events() if self.last is not None else []

    def key_averages(self):
        return self.last.key_averages() if self.last is not None else []

    def step(self, num_samples=None):
        now = time.time()
        if self._t0 is not None:
            self._times.append(now - self._t0)
        self._t0 = now
        prof = self._prof
        if prof is not None:
            was = _recording(prof)
            prof.step()
            if self._cuda and not was and _recording(prof):
                pad_window()

    def step_info(self, unit=None):
        if not self._times:
            return ''
        avg = sum(self._times[-10:]) / len(self._times[-10:])
        return 'avg step time: %.4fs' % avg

    def summary(self, **kwargs):
        print(self.step_info())


_active = [None]


def start_profiler(state='All', tracer_option='Default', log_dir=None):
    # mark active only AFTER the trace starts, so a failed start leaves
    # no stale state behind and the paired stop_profiler stays a no-op
    targets = None if state == 'All' else \
        [ProfilerTarget.GPU if state == 'GPU' else ProfilerTarget.CPU]
    prof = Profiler(targets=targets, log_dir=log_dir or _default_dir())
    prof.start()
    _active[0] = prof


def stop_profiler(sorted_key=None, profile_path=None):
    """Idempotent: safe to call repeatedly, or without a start. Returns
    the trace file's path."""
    prof, _active[0] = _active[0], None
    if prof is None:
        return None
    prof.stop()
    return prof.trace_path


@contextlib.contextmanager
def profiler(state='All', sorted_key=None, profile_path=None,
             tracer_option='Default'):
    start_profiler(state, tracer_option, profile_path)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


def export_chrome_tracing(dir_name, worker_name=None):
    """Returns an on_trace_ready callback that redirects the profiler's
    output dir (and names its worker). The Profiler invokes it at
    start(), before tracing begins, so the trace file lands under
    `dir_name` when the profiler stops."""
    def handler(prof):
        prof.log_dir = dir_name
        if worker_name:
            prof.worker_name = worker_name
    return handler


def merge_traces(rank_dirs, out_path, rank_names=None):
    """Merge per-rank chrome-tracing outputs into ONE timeline with
    per-rank lanes (reference: tools/CrossStackProfiler/ — merges
    per-trainer timelines into a cluster view).

    rank_dirs: ordered per-rank trace dirs (each a Profiler log_dir, or
    a directory a FlightRecorder exported its spans into, holding
    *.json / *.trace.json.gz chrome traces). out_path: merged
    chrome-tracing JSON, loadable in Perfetto/chrome://tracing. Every
    rank's processes are remapped into a disjoint pid range and labeled
    'rank N: <process>', so lanes group by rank.
    """
    import gzip
    import json

    _PID_STRIDE = 1 << 20
    merged = []
    total = 0
    for rank, d in enumerate(rank_dirs):
        label = (rank_names[rank] if rank_names else 'rank %d' % rank)
        events = []
        for f in load_profiler_result(d):
            if f.endswith('.trace.json.gz'):
                try:
                    with gzip.open(f, 'rt') as fh:
                        data = json.load(fh)
                except (OSError, EOFError, ValueError):
                    continue  # truncated trace (run killed mid-write)
            elif f.endswith(('.trace.json', '.json')):
                with open(f) as fh:
                    try:
                        data = json.load(fh)
                    except ValueError:
                        continue
            else:
                continue
            evs = data.get('traceEvents', data) if isinstance(data, dict) \
                else data
            if isinstance(evs, list):
                events.extend(e for e in evs if isinstance(e, dict))
        pnames = {e.get('pid'): e.get('args', {}).get('name')
                  for e in events
                  if e.get('ph') == 'M' and e.get('name') == 'process_name'}
        # collision-free remap: sequential index per distinct source pid
        pid_map = {}

        def _remap(pid):
            if pid not in pid_map:
                pid_map[pid] = rank * _PID_STRIDE + len(pid_map)
            return pid_map[pid]

        seen_pids = set()
        for e in events:
            e = dict(e)
            pid = e.get('pid', 0)
            e['pid'] = _remap(pid)
            if e.get('ph') == 'M' and e.get('name') == 'process_name':
                orig = e.get('args', {}).get('name') or str(pid)
                e['args'] = {'name': '%s: %s' % (label, orig)}
            seen_pids.add((pid, e['pid']))
            merged.append(e)
        for orig_pid, new_pid in seen_pids:
            if orig_pid not in pnames:
                merged.append({'ph': 'M', 'name': 'process_name',
                               'pid': new_pid,
                               'args': {'name': '%s: pid %s'
                                        % (label, orig_pid)}})
            merged.append({'ph': 'M', 'name': 'process_sort_index',
                           'pid': new_pid, 'args': {'sort_index': rank}})
        total += len(events)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, 'w') as fh:
        json.dump({'traceEvents': merged,
                   'metadata': {'merged_ranks': len(rank_dirs),
                                'source_events': total}}, fh)
    return out_path


def load_profiler_result(path):
    """List the trace artifacts produced under `path` (*.json /
    *.trace.json.gz per host), for tooling that post-processes traces."""
    out = []
    for root, _dirs, files in os.walk(path):
        for f in files:
            if f.endswith(('.xplane.pb', '.trace.json.gz', '.json')):
                out.append(os.path.join(root, f))
    return sorted(out)
