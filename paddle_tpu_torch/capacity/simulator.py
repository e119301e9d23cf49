"""Discrete-event fleet simulator: gateway + N replicas in fake time
(counterpart of paddle_tpu/capacity/simulator.py, copied: it needs
nothing but numpy).

Answers "how many replicas for this workload within this TTFT SLO?"
without hardware. Each simulated replica reproduces the engine's
scheduling shape (scheduler.py): slot admission, one prefill chunk per
resident prompt per step, one shared decode burst per step for every
slot whose prompt is consumed — so a request occupies a slot for
ceil(prompt/chunk) + ceil(new_tokens/block) steps, and step WALL TIME is
the two-parameter service model below. The simulator advances replicas
step-by-step in simulated seconds, so queueing, slot occupancy,
prefix-cache hits, replica failover and the gateway's autoscaler policy
all emerge from the same mechanics the real gateway has.

Service model (per replica):

    step_s = prefilling_slots * prefill_chunk_s
             + (decode_burst_s if any slot is decoding)

calibrated three ways: `ServiceModel.from_events` fits the two
parameters from a short measured run's wide events (the calibration
gate's path), `from_bench_rows` backs them out of stored bench rows,
and `from_roofline` parameterizes them analytically from the cost
model's peaks (monitor/perf/costmodel.py: the card's datasheet row).

Validation is distributional: `ttft_divergence` / `compare_events`
report the K-S statistic and p50/p99 relative error between simulated
and real TTFTs of the SAME trace; tools/capacity_report.py gates on
them. `sweep_replicas` then runs the calibrated model across replica
counts — a million-request sweep completes in seconds on CPU because
the per-step inner loop is O(num_slots) plain-int work and traces stay
columnar (no prompts, no per-token events).
"""
import heapq

import numpy as np

__all__ = ['ServiceModel', 'SimResult', 'simulate', 'sweep_replicas',
           'sweep_qos', 'ks_statistic', 'ttft_divergence',
           'compare_events', 'ttfts_of_events']


class ServiceModel:
    """Two-parameter wall-time model of one replica's engine step."""

    def __init__(self, prefill_chunk_s, decode_burst_s, prefill_chunk=32,
                 decode_block=8, num_slots=8):
        if prefill_chunk_s < 0 or decode_burst_s <= 0:
            raise ValueError('service times must be positive')
        self.prefill_chunk_s = float(prefill_chunk_s)
        self.decode_burst_s = float(decode_burst_s)
        self.prefill_chunk = int(prefill_chunk)
        self.decode_block = int(decode_block)
        self.num_slots = int(num_slots)

    def to_dict(self):
        return {'prefill_chunk_s': self.prefill_chunk_s,
                'decode_burst_s': self.decode_burst_s,
                'prefill_chunk': self.prefill_chunk,
                'decode_block': self.decode_block,
                'num_slots': self.num_slots}

    @classmethod
    def from_events(cls, events, prefill_chunk=32, decode_block=8,
                    num_slots=8, trace=None, replicas=1,
                    router='least_loaded'):
        """Calibrate from measured wide events (a short replay through
        the real gateway). Decode: the engine delivers decode_block
        tokens per burst, and the first token is stamped at the end of
        the FIRST burst — so first_token->finish spans
        ceil(out/block) - 1 bursts:
        decode_burst_s = median((finish-first) / (ceil(out/block)-1)).

        Prefill: first_token lands one chunked prefill plus one burst
        after admission, but under load (ft - admit) also contains the
        co-resident prefill work the SIMULATOR will model again — so
        the direct median((first-admit-burst)/chunks) overestimates the
        solo chunk cost by the contention factor and the sim
        double-counts it. When the measured run's `trace` is given, the
        chunk cost is instead found by bisection: the value whose
        simulated p50 TTFT (replicas/router as measured) matches the
        measured p50. The gate still validates honestly — K-S and p99
        probe the whole distribution, not the matched median."""
        dec, pre = [], []
        for e in events:
            ft, fin = e.get('first_token_t'), e.get('finish_t')
            out = int(e.get('output_tokens') or 0)
            bursts = -(-out // decode_block) - 1
            if ft is not None and fin is not None and bursts >= 1:
                dec.append((fin - ft) / bursts)
        if not dec:
            raise ValueError('no events with decode timing to calibrate '
                             'from (need output_tokens > decode_block)')
        burst_s = max(float(np.median(dec)), 1e-9)
        for e in events:
            ad, ft = e.get('admit_t'), e.get('first_token_t')
            chunks = int(e.get('prefill_chunks') or 0)
            if ad is not None and ft is not None and chunks > 0:
                pre.append(max(0.0, (ft - ad) - burst_s) / chunks)
        chunk_s = float(np.median(pre)) if pre else burst_s
        if trace is not None:
            target = float(np.median(ttfts_of_events(events)))
            lo, hi = 0.0, max(chunk_s, burst_s, 1e-6) * 2.0
            for _ in range(20):
                mid = (lo + hi) / 2.0
                m = cls(mid, burst_s, prefill_chunk=prefill_chunk,
                        decode_block=decode_block, num_slots=num_slots)
                p50 = simulate(trace, m, replicas=replicas,
                               router=router,
                               advance_every=1).ttft_percentiles(
                                   (50,))[50]
                if p50 < target:
                    lo = mid
                else:
                    hi = mid
            chunk_s = (lo + hi) / 2.0
        return cls(chunk_s, burst_s, prefill_chunk=prefill_chunk,
                   decode_block=decode_block, num_slots=num_slots)

    @classmethod
    def from_bench_rows(cls, rows, metric='serving_cb_tokens_per_sec',
                        prefill_chunk=32, decode_block=8, num_slots=None):
        """Back the burst pace out of a stored serving bench row:
        saturated continuous batching delivers slots*block tokens per
        burst, so burst_s = slots*block / tokens_per_sec. Coarse (the
        row's tok/s includes prefill overhead) — prefer from_events when
        a measured run is available."""
        best = None
        for r in rows:
            if (r.get('metric') == metric
                    and isinstance(r.get('value'), (int, float))
                    and r['value'] > 0):
                if best is None or r['value'] > best['value']:
                    best = r
        if best is None:
            raise ValueError('no usable %r row' % (metric,))
        slots = int(num_slots or best.get('num_slots') or 8)
        burst_s = slots * decode_block / float(best['value'])
        return cls(burst_s, burst_s, prefill_chunk=prefill_chunk,
                   decode_block=decode_block, num_slots=slots)

    @classmethod
    def from_roofline(cls, param_count, param_bytes, platform=None,
                      prefill_chunk=32, decode_block=8, num_slots=8):
        """Analytic floor from the cost model: one decode token
        step streams the weights once and does 2*params*slots FLOPs; a
        prefill chunk does 2*params*chunk FLOPs over the same weights."""
        from ..monitor.perf.costmodel import roofline
        tok = roofline(2.0 * param_count * num_slots, param_bytes,
                       platform=platform)['ideal_step_s']
        chunk = roofline(2.0 * param_count * prefill_chunk, param_bytes,
                         platform=platform)['ideal_step_s']
        return cls(chunk, tok * decode_block, prefill_chunk=prefill_chunk,
                   decode_block=decode_block, num_slots=num_slots)


class _Replica:
    """One simulated engine: local clock + FIFO queue + slot table.
    Advanced lazily to the fleet's routing time; each iteration of
    `advance` is ONE engine step."""

    __slots__ = ('t', 'queue', 'active', 'slots', 'seen_prefix', 'alive',
                 'draining', 'outstanding', 'busy_slot_s', 'ready')

    def __init__(self, t0, slots):
        self.t = float(t0)
        self.queue = []          # (req_idx, arrival_t) FIFO (index head)
        self.active = []         # [req_idx, chunks_left, tokens_left]
        self.slots = slots
        self.seen_prefix = set()
        self.alive = True
        self.draining = False
        self.outstanding = 0
        self.busy_slot_s = 0.0
        self.ready = []          # QoS staging heap: (-priority, req_idx)


class SimResult:
    """Columnar per-request outcomes of one simulation.

    `outcome` / `priority` / `reject_reason` columns are present only
    for QoS runs (simulate(..., qos=...)); without a policy they are
    None and every request is implicitly admitted ('ok')."""

    def __init__(self, trace, admit, first, finish, failovers, replica_of,
                 prefix_hits, chunks, replica_timeline, wall_s,
                 outcome=None, priority=None, reject_reason=None):
        self.trace = trace
        self.admit = admit
        self.first = first
        self.finish = finish
        self.failovers = failovers
        self.replica_of = replica_of
        self.prefix_hits = prefix_hits
        self.chunks = chunks
        self.replica_timeline = replica_timeline   # [(sim_t, n_alive)]
        self.wall_s = wall_s                       # host seconds to run
        self.outcome = outcome                     # 'ok' | 'rejected'
        self.priority = priority
        self.reject_reason = reject_reason

    def __len__(self):
        return len(self.trace)

    @property
    def max_replicas(self):
        return max(n for _, n in self.replica_timeline)

    def ok_mask(self):
        """Admitted requests — the ones latency statistics make sense
        for (a shed request never produced a token)."""
        if self.outcome is None:
            return np.ones(len(self), dtype=bool)
        return self.outcome == 'ok'

    def ttft(self):
        return (self.first - self.trace.arrival)[self.ok_mask()]

    def queue_wait(self):
        return (self.admit - self.trace.arrival)[self.ok_mask()]

    def ttft_percentiles(self, qs=(50, 99)):
        t = self.ttft()
        return {q: float(np.percentile(t, q)) for q in qs}

    def ttft_percentiles_by_model(self, qs=(50, 99)):
        """{model name: {q: ttft}} over admitted requests; empty for a
        single-model trace (no named models to break down by)."""
        names = getattr(self.trace, 'model_names', None)
        if not names:
            return {}
        t = self.first - self.trace.arrival
        m = self.ok_mask()
        out = {}
        for idx, name in enumerate(names):
            mask = m & (self.trace.model_id == idx)
            if mask.any():
                out[name] = {q: float(np.percentile(t[mask], q))
                             for q in qs}
        return out

    def ttft_percentiles_by_priority(self, qs=(50, 99)):
        """{priority: {q: ttft}} over admitted requests — the graceful-
        degradation read: premium classes should hold their tail while
        the background class absorbs the shedding."""
        if self.priority is None:
            return {0: self.ttft_percentiles(qs)}
        t = self.first - self.trace.arrival
        m = self.ok_mask()
        out = {}
        for p in sorted(set(int(x) for x in self.priority)):
            mask = m & (self.priority == p)
            if mask.any():
                out[int(p)] = {q: float(np.percentile(t[mask], q))
                               for q in qs}
        return out

    def summary(self, slo_ttft_s=None):
        p = self.ttft_percentiles((50, 90, 99))
        out = {'requests': len(self), 'max_replicas': self.max_replicas,
               'sim_duration_s': float(self.finish.max()),
               'wall_s': round(self.wall_s, 3),
               'ttft_p50_s': p[50], 'ttft_p90_s': p[90],
               'ttft_p99_s': p[99],
               'queue_wait_p99_s': float(np.percentile(self.queue_wait(),
                                                       99)),
               'failovers': int(self.failovers.sum()),
               'prefix_hit_requests': int(self.prefix_hits.sum())}
        if self.outcome is not None:
            rej = int((self.outcome == 'rejected').sum())
            out['rejected'] = rej
            out['shed_rate'] = rej / float(len(self))
        if slo_ttft_s is not None:
            out['slo_ttft_s'] = float(slo_ttft_s)
            out['slo_ok'] = bool(p[99] <= slo_ttft_s)
        return out

    def to_events(self):
        """Wide-event-schema dicts (one per request) so simulated runs
        join the same offline tooling as real ones. Only sensible for
        calibration-scale runs — a million dicts defeats the columnar
        point."""
        tr = self.trace
        names = tr.tenant_names
        mnames = getattr(tr, 'model_names', None)
        out = []
        for i in range(len(tr)):
            shed = (self.outcome is not None
                    and self.outcome[i] == 'rejected')
            out.append({
                'request_id': 'sim-%d' % i,
                'tenant': names[tr.tenant_id[i]],
                'model': (mnames[tr.model_id[i]]
                          if mnames is not None else None),
                'priority': (int(self.priority[i])
                             if self.priority is not None else 0),
                'trace_id': None,
                'arrival_t': float(tr.arrival[i]),
                # a shed request never reached a replica: no admit, no
                # first token (ttfts_of_events skips the Nones)
                'admit_t': None if shed else float(self.admit[i]),
                'first_token_t': None if shed else float(self.first[i]),
                'finish_t': float(self.finish[i]),
                'queue_wait_s': (0.0 if shed else
                                 float(self.admit[i] - tr.arrival[i])),
                'prefill_chunks': int(self.chunks[i]),
                'prompt_tokens': int(tr.prompt_len[i]),
                'output_tokens': 0 if shed else int(tr.new_tokens[i]),
                'prefix_hit_tokens': int(tr.prefix_len[i])
                if self.prefix_hits[i] else 0,
                'spec_proposed': 0, 'spec_accepted': 0,
                'kv_page_seconds': (0.0 if shed else
                                    float(self.finish[i] - self.admit[i])),
                'failovers': int(self.failovers[i]),
                'replicas': ([] if shed else
                             ['sim://replica-%d' % self.replica_of[i]]),
                'outcome': ('rejected' if shed else 'ok')})
        return out


def _burn_rate(ttft_log, now, slo, window):
    recent = [v for (t, v) in ttft_log if now - t <= window]
    if not recent:
        return 0.0
    return sum(1 for v in recent if v > slo) / float(len(recent))


def simulate(trace, model, replicas=2, router='least_loaded', policy=None,
             autoscale_tick_s=None, kill_at=None, advance_every=None,
             registry=None, qos=None):
    """Run `trace` through a simulated fleet of `replicas` engines.

    router: 'least_loaded' (the gateway's policy, replicas advanced to
    each arrival before routing) or 'round_robin' (cheaper; the default
    pick for million-request sweeps via `advance_every` batching).
    policy: an AutoscalePolicy-shaped object; its decide() is evaluated
    every `autoscale_tick_s` simulated seconds and +1/-1 deltas add or
    drain replicas, exactly as ServingGateway.autoscale_tick applies
    them. kill_at: {replica_index: sim_time} hard failures — queued and
    resident requests re-route with failovers+1 and restart service.
    advance_every: advance replicas every N arrivals instead of every
    arrival (default 1 when n <= 20k, else 1024 — the batching that
    keeps million-request sweeps in seconds).
    qos: a capacity.qos.QosPolicy — the gateway's admission layer in
    simulated time. Arrivals failing the per-tenant rate/quota check
    shed at the front door (outcome 'rejected', no replica time), and
    replica queues serve highest priority first, FIFO within a class.
    The sim deliberately does NOT model KV preemption — admission +
    priority ordering dominate fleet-level tails, and the pessimistic
    error (a resident low-priority request holding its slot) is the
    safe direction for capacity planning. NOTE: the policy object is
    STATEFUL (buckets, inflight counts) and gets consumed by the run —
    pass a fresh instance per simulate() call (sweep_qos does).
    """
    import time as _time
    host0 = _time.monotonic()
    n = len(trace)
    if n < 1:
        raise ValueError('empty trace')
    if advance_every is None:
        advance_every = 1 if n <= 20000 else 1024
    chunk_s = model.prefill_chunk_s
    burst_s = model.decode_burst_s
    chunk = model.prefill_chunk
    block = model.decode_block
    slots = model.num_slots

    # plain-python columns: the inner loop is integer/float arithmetic
    # and numpy scalar boxing would dominate it
    arrival = trace.arrival.tolist()
    prompt_len = trace.prompt_len.tolist()
    new_tokens = trace.new_tokens.tolist()
    prefix_group = trace.prefix_group.tolist()
    prefix_len = trace.prefix_len.tolist()

    admit = [0.0] * n
    first = [0.0] * n
    finish = [0.0] * n
    failovers = [0] * n
    replica_of = [0] * n
    prefix_hits = [False] * n
    chunks_of = [0] * n

    # QoS columns (only materialized when a policy is active)
    tenant_of = prio = outcome = reason_of = None
    if qos is not None:
        names = trace.tenant_names
        tids = trace.tenant_id.tolist()
        prio_of_tid = [int(qos.priority_of(nm)) for nm in names]
        tenant_of = [names[t] for t in tids]
        prio = [prio_of_tid[t] for t in tids]
        outcome = ['ok'] * n
        reason_of = [None] * n

    pool = [_Replica(0.0, slots) for _ in range(int(replicas))]
    timeline = [(0.0, len(pool))]
    ttft_log = []
    slo = getattr(policy, 'slo_ttft_s', 1.0)
    window = getattr(policy, 'window_s', 30.0)
    if policy is not None and autoscale_tick_s is None:
        autoscale_tick_s = max(getattr(policy, 'sustain_s', 1.0) / 2.0,
                               1e-3)
    next_tick = autoscale_tick_s if policy is not None else None

    def advance(rep, until, ridx):
        """Engine steps until the local clock passes `until` or the
        replica runs dry. One loop iteration == one engine step; a step
        in flight completes past `until` (steps are not preemptible)."""
        t = rep.t
        queue = rep.queue
        qh = 0  # consumed queue head (popped in bulk afterwards)
        while True:
            act = rep.active
            if not act:
                if qh:
                    del queue[:qh]
                    qh = 0
                if prio is not None and rep.ready:
                    pass          # admissible work is already staged
                elif not queue:
                    break
                else:
                    # idle: jump the local clock to the head arrival
                    t = max(t, queue[0][1])
            if t >= until:
                break
            # ADMIT arrived requests into free slots at the step top.
            # With a QoS policy, arrived entries stage through a
            # priority heap first — highest class served first, trace
            # order within a class — so the pick stays O(log n) even
            # when deep overload piles up an arrived backlog (a linear
            # best-scan goes quadratic exactly when QoS matters most).
            if prio is not None:
                while qh < len(queue) and queue[qh][1] <= t:
                    e = queue[qh]
                    qh += 1
                    heapq.heappush(rep.ready, (-prio[e[0]], e[0]))
            while len(act) < rep.slots:
                if prio is None:
                    if qh >= len(queue) or queue[qh][1] > t:
                        break
                    ri = queue[qh][0]
                    qh += 1
                else:
                    if not rep.ready:
                        break
                    ri = heapq.heappop(rep.ready)[1]
                admit[ri] = t
                g = prefix_group[ri]
                eff = prompt_len[ri]
                if g >= 0:
                    if g in rep.seen_prefix:
                        eff = eff - prefix_len[ri]
                        if eff < 1:
                            eff = 1
                        prefix_hits[ri] = True
                    else:
                        rep.seen_prefix.add(g)
                nchunks = (eff + chunk - 1) // chunk
                chunks_of[ri] = nchunks
                act.append([ri, nchunks, new_tokens[ri]])
            if not act:
                # head not yet arrived: idle until it does
                t = max(t, queue[qh][1])
                continue
            if qh > 512:
                del queue[:qh]
                qh = 0
            # PREFILL one chunk per consuming prompt, then one shared
            # DECODE burst for every consumed slot — scheduler.py's step
            npre = 0
            decoding = False
            for rec in act:
                if rec[1] > 0:
                    rec[1] -= 1
                    npre += 1
                if rec[1] == 0:
                    decoding = True
            dt = npre * chunk_s + (burst_s if decoding else 0.0)
            t += dt
            rep.busy_slot_s += dt * len(act)
            if decoding:
                done_any = False
                for rec in act:
                    if rec[1] == 0:
                        ri = rec[0]
                        left = rec[2]
                        if left == new_tokens[ri]:
                            first[ri] = t
                            ttft_log.append((t, t - arrival[ri]))
                        left -= block
                        rec[2] = left
                        if left <= 0:
                            finish[ri] = t
                            replica_of[ri] = ridx
                            rep.outstanding -= 1
                            if qos is not None:
                                qos.finish(tenant_of[ri])
                            done_any = True
                if done_any:
                    rep.active = [r for r in act if r[2] > 0]
        if qh:
            del queue[:qh]
        rep.t = max(t, rep.t)

    def advance_all(until):
        for ridx, r in enumerate(pool):
            if r.alive:
                advance(r, until, ridx)

    def route(i, arr, fo=0):
        live = [r for r in pool if r.alive and not r.draining]
        if not live:
            live = [r for r in pool if r.alive]
        if not live:
            raise RuntimeError('all simulated replicas are dead at '
                               't=%.3f' % arr)
        if router == 'round_robin':
            rep = live[(i + fo) % len(live)]
        else:
            rep = min(live, key=lambda r: r.outstanding)
        rep.queue.append((i, arr))
        rep.outstanding += 1

    def kill(idx, now):
        rep = pool[idx]
        if not rep.alive:
            return
        rep.alive = False
        orphans = [ri for (ri, _) in rep.queue]
        orphans += [e[1] for e in rep.ready]
        orphans += [rec[0] for rec in rep.active if rec[2] > 0]
        rep.queue = []
        rep.ready = []
        rep.active = []
        rep.outstanding = 0
        timeline.append((now, sum(1 for r in pool if r.alive)))
        for ri in orphans:
            failovers[ri] += 1
            route(ri, now, fo=failovers[ri])

    def tick(now):
        live = [r for r in pool if r.alive]
        occ = (sum(len(r.active) for r in live)
               / float(max(1, sum(r.slots for r in live))))
        qd = sum(len(r.queue) for r in live)
        burn = _burn_rate(ttft_log[-4096:], now, slo, window)
        d = policy.decide(now, burn, occ, qd, len(live))
        if d.delta > 0:
            pool.append(_Replica(now, slots))
            timeline.append((now, sum(1 for r in pool if r.alive)))
        elif d.delta < 0:
            victims = [r for r in live if not r.draining]
            if len(victims) > 1:
                min(victims, key=lambda r: r.outstanding).draining = True
                timeline.append(
                    (now, sum(1 for r in pool
                              if r.alive and not r.draining)))

    pending_kills = sorted((kill_at or {}).items(), key=lambda kv: kv[1])
    i = 0
    while i < n:
        now = arrival[i]
        while pending_kills and pending_kills[0][1] <= now:
            idx, kt = pending_kills.pop(0)
            advance_all(kt)
            kill(idx, kt)
        if next_tick is not None and now >= next_tick:
            advance_all(next_tick)
            tick(next_tick)
            next_tick += autoscale_tick_s
            continue
        stop = min(i + advance_every, n)
        if router != 'round_robin' or advance_every == 1:
            advance_all(now)
        broke = False
        for j in range(i, stop):
            if next_tick is not None and arrival[j] >= next_tick:
                stop = j
                broke = True
                break
            if pending_kills and pending_kills[0][1] <= arrival[j]:
                stop = j
                broke = True
                break
            if qos is not None:
                ok, why = qos.admit(arrival[j], tenant_of[j])
                if not ok:
                    # shed at the front door: the request costs no
                    # replica time and its "latency" is undefined
                    outcome[j] = 'rejected'
                    reason_of[j] = why
                    admit[j] = first[j] = finish[j] = arrival[j]
                    continue
            route(j, arrival[j], fo=0)
        if not broke and router == 'round_robin' and stop > i:
            advance_all(arrival[stop - 1])
        # stop == i only when a tick/kill interrupted at the batch head;
        # the top-of-loop handlers then consume it before routing resumes
        i = stop

    # drain: apply any kills past the last arrival, then run every
    # surviving replica dry (the autoscaler holds during drain — no
    # arrivals means no routing for a new replica to absorb)
    while pending_kills:
        idx, kt = pending_kills.pop(0)
        advance_all(kt)
        kill(idx, kt)
    while True:
        busy = False
        for ridx, r in enumerate(pool):
            if r.alive and (r.queue or r.ready or r.active):
                advance(r, float('inf'), ridx)
                busy = True
        if not busy:
            break

    wall = _time.monotonic() - host0
    res = SimResult(trace,
                    np.asarray(admit), np.asarray(first),
                    np.asarray(finish),
                    np.asarray(failovers, dtype=np.int64),
                    np.asarray(replica_of, dtype=np.int64),
                    np.asarray(prefix_hits, dtype=bool),
                    np.asarray(chunks_of, dtype=np.int64),
                    timeline, wall,
                    outcome=(None if outcome is None
                             else np.asarray(outcome)),
                    priority=(None if prio is None
                              else np.asarray(prio, dtype=np.int64)),
                    reject_reason=(None if reason_of is None
                                   else np.asarray(reason_of,
                                                   dtype=object)))
    if registry is not None:
        from ..monitor.telemetry import record_capacity_schema
        fams = record_capacity_schema(registry)
        fams['sim_requests_total'].inc(n)
        fams['sim_runs_total'].inc()
        fams['sim_last_p99_ttft_seconds'].set(
            res.ttft_percentiles((99,))[99])
    return res


def sweep_replicas(trace, model, counts=(1, 2, 4, 8, 16), slo_ttft_s=1.0,
                   percentile=99, router='round_robin',
                   advance_every=None, registry=None):
    """Simulate `trace` at each replica count; report the TTFT tail per
    point and the minimum count whose p<percentile> TTFT meets the SLO
    (None when no swept count does — scale the sweep, not the claim)."""
    points = []
    min_replicas = None
    for c in sorted(set(int(c) for c in counts)):
        res = simulate(trace, model, replicas=c, router=router,
                       advance_every=advance_every, registry=registry)
        p = res.ttft_percentiles((50, percentile))
        ok = p[percentile] <= slo_ttft_s
        point = {'replicas': c, 'ttft_p50_s': p[50],
                 'ttft_p%d_s' % percentile: p[percentile],
                 'sim_wall_s': round(res.wall_s, 3),
                 'meets_slo': bool(ok)}
        by_model = res.ttft_percentiles_by_model((percentile,))
        if by_model:
            # only multi-model traces carry the column, so single-model
            # sweep output stays byte-stable for downstream parsers
            point['ttft_by_model'] = {m: v[percentile]
                                      for m, v in sorted(by_model.items())}
        points.append(point)
        if ok and min_replicas is None:
            min_replicas = c
    return {'slo_ttft_s': float(slo_ttft_s), 'percentile': int(percentile),
            'requests': len(trace), 'points': points,
            'min_replicas': min_replicas}


def sweep_qos(trace, model, policies, replicas=2, slo_ttft_s=1.0,
              percentile=99, router='round_robin', advance_every=None):
    """Simulate the same trace and fleet under each admission policy.

    `policies`: [(name, QosPolicy-or-dict)] pairs (or a {name: policy}
    dict). Policies are re-materialized per run via to_dict/from_dict —
    QosPolicy instances are stateful, and a sweep must not leak bucket
    levels across points. Each point reports the overall admitted-TTFT
    tail, the shed rate, and the per-priority-class tail; `meets_slo`
    asks whether the HIGHEST priority class holds the SLO — the
    graceful-degradation question, not the aggregate one.
    """
    from .qos import QosPolicy
    if isinstance(policies, dict):
        policies = sorted(policies.items())
    points = []
    for name, pol in policies:
        spec = pol if isinstance(pol, dict) else pol.to_dict()
        res = simulate(trace, model, replicas=replicas, router=router,
                       advance_every=advance_every,
                       qos=QosPolicy.from_dict(spec))
        s = res.summary()
        by = res.ttft_percentiles_by_priority((percentile,))
        top = max(by) if by else 0
        points.append({
            'policy': name,
            'ttft_p%d_s' % percentile:
                res.ttft_percentiles((percentile,))[percentile],
            'rejected': s.get('rejected', 0),
            'shed_rate': s.get('shed_rate', 0.0),
            'by_priority': {str(p): v[percentile]
                            for p, v in sorted(by.items())},
            'meets_slo': bool(by and by[top][percentile] <= slo_ttft_s)})
    return {'slo_ttft_s': float(slo_ttft_s), 'percentile': int(percentile),
            'requests': len(trace), 'replicas': int(replicas),
            'points': points}


# ---------------------------------------------------------------------------
# sim-vs-real divergence


def ks_statistic(a, b):
    """Two-sample Kolmogorov-Smirnov statistic: sup |F_a - F_b|."""
    a = np.sort(np.asarray(a, dtype=np.float64))
    b = np.sort(np.asarray(b, dtype=np.float64))
    if not len(a) or not len(b):
        return 1.0
    grid = np.concatenate([a, b])
    fa = np.searchsorted(a, grid, side='right') / float(len(a))
    fb = np.searchsorted(b, grid, side='right') / float(len(b))
    return float(np.max(np.abs(fa - fb)))


def _rel_err(sim, real):
    return abs(sim - real) / max(abs(real), 1e-12)


def ttft_divergence(sim_ttfts, real_ttfts):
    """K-S plus p50/p99 relative error between two TTFT samples (any
    units, as long as both sides agree)."""
    sim = np.asarray(sim_ttfts, dtype=np.float64)
    real = np.asarray(real_ttfts, dtype=np.float64)
    if not len(sim) or not len(real):
        raise ValueError('both TTFT samples must be non-empty')
    sp50, sp99 = np.percentile(sim, 50), np.percentile(sim, 99)
    rp50, rp99 = np.percentile(real, 50), np.percentile(real, 99)
    return {'ks': ks_statistic(sim, real),
            'p50_rel_err': _rel_err(sp50, rp50),
            'p99_rel_err': _rel_err(sp99, rp99),
            'sim_p50_s': float(sp50), 'sim_p99_s': float(sp99),
            'real_p50_s': float(rp50), 'real_p99_s': float(rp99),
            'sim_n': int(len(sim)), 'real_n': int(len(real))}


def ttfts_of_events(events):
    """TTFT seconds from wide events (first_token_t - arrival_t),
    skipping requests that never produced a token."""
    out = []
    for e in events:
        a, f = e.get('arrival_t'), e.get('first_token_t')
        if a is not None and f is not None:
            out.append(f - a)
    return out


def compare_events(sim_events, real_events, min_samples=3):
    """Per-tenant + overall ttft_divergence between two wide-event sets
    (the capacity_report join). Tenants with fewer than `min_samples`
    TTFTs on either side are reported but not compared."""
    def split(events):
        by = {}
        for e in events:
            a, f = e.get('arrival_t'), e.get('first_token_t')
            if a is None or f is None:
                continue
            by.setdefault(e.get('tenant') or 'default', []).append(f - a)
        return by

    sim_by, real_by = split(sim_events), split(real_events)
    out = {'overall': ttft_divergence(
        [v for vs in sim_by.values() for v in vs],
        [v for vs in real_by.values() for v in vs]), 'tenants': {}}
    for tenant in sorted(set(sim_by) | set(real_by)):
        s, r = sim_by.get(tenant, []), real_by.get(tenant, [])
        if len(s) >= min_samples and len(r) >= min_samples:
            out['tenants'][tenant] = ttft_divergence(s, r)
        else:
            out['tenants'][tenant] = {'skipped': 'insufficient samples',
                                      'sim_n': len(s), 'real_n': len(r)}
    return out


def min_replicas_for(trace, model, slo_ttft_s, counts=(1, 2, 4, 8, 16),
                     percentile=99, **kw):
    """Convenience: sweep and return (min_replicas, sweep dict)."""
    sweep = sweep_replicas(trace, model, counts=counts,
                           slo_ttft_s=slo_ttft_s, percentile=percentile,
                           **kw)
    return sweep['min_replicas'], sweep
