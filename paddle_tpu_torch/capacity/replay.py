"""Open-loop trace replay against the real ServingGateway (counterpart of
paddle_tpu/capacity/replay.py).

`replay` submits a `Trace`'s requests with arrival-time-faithful pacing
(open loop: the clock, not completions, drives submission — slow
servers queue, they don't slow the workload down), reconstructing each
request's prompt tokens, tenant and output budget from the trace
columns. The gateway emits the canonical 18-field wide events exactly
as production traffic would, so a replayed run of a trace can be held
against a recording of the same trace (the reference's fleet simulator
calibrates against such runs).

`measure` wraps the full calibration recipe: install a fresh
RequestLog, build + warm a gateway, replay, and hand back the run's
wide events (sliced out of the log with the since_ts filter so warmup
and earlier traffic never pollute the fit).

Serving imports happen inside functions: `paddle_tpu_torch.capacity`
stays importable without torch's serving machinery, which loads only
when a real gateway is actually driven.
"""
import time

__all__ = ['ReplayResult', 'replay', 'measure']


class ReplayResult:
    """What one open-loop replay did, in host wall-time terms."""

    def __init__(self, requests, completed, wall_s, tokens, max_lag_s,
                 handles=()):
        self.requests = requests
        self.completed = completed   # finished within the wait budget
        self.wall_s = wall_s
        self.tokens = tokens
        self.max_lag_s = max_lag_s   # worst submit-behind-schedule, s
        self.handles = list(handles)  # GatewayRequest per trace index

    @property
    def tokens_per_sec(self):
        return self.tokens / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def completed_ratio(self):
        return self.completed / self.requests if self.requests else 1.0

    def to_dict(self):
        return {'requests': self.requests, 'completed': self.completed,
                'completed_ratio': self.completed_ratio,
                'wall_s': self.wall_s,
                'tokens': self.tokens, 'max_lag_s': self.max_lag_s,
                'tokens_per_sec': self.tokens_per_sec}


def replay(gateway, trace, speed=1.0, max_new_tokens=None, seed=0,
           timeout=600.0, before_submit=None, registry=None):
    """Replay `trace` through a start()ed gateway; returns ReplayResult.

    speed: time compression — 2.0 replays a trace twice as fast as
    recorded (arrival gaps divide by `speed`). max_new_tokens overrides
    the trace's per-request output budgets (benches cap decode work).
    seed: sampling seed for every request — engines are deterministic
    per (prompt, sampling, seed), which is what makes failover
    exact-token and replays reproducible. before_submit(i) runs just
    before request i is submitted — the hook bench_serving_gateway uses
    to kill a replica mid-burst at the same point the retired inline
    loop did. Requests still unfinished after `timeout` seconds (each)
    are left behind and counted out of `completed` — the chaos bench's
    completed_ratio, not an exception.
    """
    if speed <= 0:
        raise ValueError('speed must be positive')
    prompts = trace.prompts()
    tenants = trace.tenants()
    models = trace.models() if hasattr(trace, 'models') else None
    new_tokens = trace.new_tokens.tolist()
    arrival = trace.arrival.tolist()

    fams = None
    if registry is not None:
        from ..monitor.telemetry import record_capacity_schema
        fams = record_capacity_schema(registry)

    t0 = time.monotonic()
    max_lag = 0.0
    handles = []
    for i in range(len(trace)):
        target = t0 + arrival[i] / speed
        now = time.monotonic()
        if target > now:
            time.sleep(target - now)
        else:
            max_lag = max(max_lag, now - target)
        if before_submit is not None:
            before_submit(i)
        mnt = int(max_new_tokens if max_new_tokens is not None
                  else new_tokens[i])
        extra = {} if models is None else {'model': models[i]}
        handles.append(gateway.submit(prompts[i], max_new_tokens=mnt,
                                      tenant=tenants[i], seed=seed,
                                      **extra))
    for h in handles:
        h.wait(timeout)
    wall = time.monotonic() - t0
    tokens = sum(len(h.tokens) for h in handles)
    # done-with-error handles are shed/failed requests (an admission
    # reject finishes instantly) — they must not inflate completed
    completed = sum(1 for h in handles if h.done and h.error is None)
    if fams is not None:
        fams['capacity_requests_replayed_total'].inc(len(handles))
        fams['capacity_replay_runs_total'].inc()
        fams['capacity_replay_lag_seconds'].observe(max_lag)
    return ReplayResult(len(handles), completed, wall, tokens, max_lag,
                        handles=handles)


def measure(engine_factory, trace, replicas=1, speed=1.0,
            max_new_tokens=None, warmup_prompt=None, timeout=600.0,
            registry=None, log_capacity=None):
    """Calibration run: replay `trace` through a fresh in-proc gateway
    and return (events, ReplayResult) where `events` are the replay's
    own wide events — warmup excluded via the RequestLog since_ts
    filter.

    engine_factory: zero-arg callable building one engine replica (the
    same factory ServingGateway takes). warmup_prompt: token list used
    for one blocking generate() before the clock starts, so compile
    time never lands in the measured TTFTs (default: the trace's first
    prompt).
    """
    from ..monitor import events as _events
    from ..serving.gateway.gateway import ServingGateway

    log = _events.RequestLog(capacity=max(2048, 4 * len(trace))
                             if log_capacity is None else log_capacity)
    prev = _events.default_request_log()
    _events.set_default_request_log(log)
    try:
        gw = ServingGateway(engine_factory, replicas=replicas,
                            registry=registry)
        warm = warmup_prompt if warmup_prompt is not None \
            else trace.prompts()[0]
        gw.generate([warm], max_new_tokens=4, tenant='warmup')
        gw.start()
        try:
            mark = time.monotonic()
            result = replay(gw, trace, speed=speed,
                            max_new_tokens=max_new_tokens,
                            timeout=timeout, registry=registry)
        finally:
            gw.shutdown()
        events = log.events(since_ts=mark)
        return events, result
    finally:
        _events.set_default_request_log(prev)
