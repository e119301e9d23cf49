"""Workload language: seeded, deterministic request traces (counterpart
of paddle_tpu/capacity/workload.py, copied: numpy only, so the same spec
gives the same arrays and the same `hash` in both packages).

A `WorkloadSpec` is a declarative, JSON-serializable description of a
serving workload — arrival process (Poisson, diurnal cycle, correlated
bursts, all-at-zero burst), prompt/output length distributions (fixed,
ladder, lognormal, Zipf), tenant mix (round-robin, weighted, Zipf skew)
and shared-prefix structure. `generate()` turns a spec into a `Trace`:
a columnar, wide-event-schema-aligned request list (arrival_t, tenant,
prompt_tokens, output_tokens, prefix group) that the replay harness
feeds to the real gateway (and the reference's fleet simulator consumes
directly).

Determinism is the contract: the same (spec, seed) produces a
byte-identical trace — arrivals, lengths, tenants AND prompt token ids
— so a bench rung, a replay and a simulation all see the same workload,
and the spec's canonical hash recorded in a bench row names the trace
exactly. The RNG stream discipline mirrors the historical bench_extra
generators bit-for-bit: arrivals come from `RandomState(seed)`
exponential draws (the old `_poisson_arrivals`), prompt tokens from a
second `RandomState(seed)` consumed strictly in request order (shared
prefixes drawn at first use), so stored bench bests keyed to the old
hand-rolled traces stay comparable.

Traces round-trip through JSONL (`Trace.to_jsonl`/`from_jsonl`), and
recorded wide events — a `RequestLog` sink or dryrun `request_event`
lines — load into the same in-memory form via `trace_from_events` /
`load_trace`, which is how production traffic becomes a replayable,
simulatable workload. Prompt token ids are materialized lazily
(`Trace.prompts()`): a million-request trace for the simulator never
allocates them.
"""
import hashlib
import json
import math
import zlib

import numpy as np

__all__ = ['WorkloadSpec', 'Trace', 'generate', 'trace_from_events',
           'load_trace', 'poisson_arrivals']

_TWO_PI = 2.0 * math.pi


def _stream_seed(seed, name):
    """Seed for an auxiliary RNG stream. The 'arrival' and 'prompt'
    streams use `seed` verbatim (bench_extra parity); everything else
    derives a stable per-purpose stream so adding a knob never shifts
    the draws of an existing one."""
    return (int(seed) ^ zlib.crc32(name.encode('utf-8'))) & 0x7FFFFFFF


def poisson_arrivals(n, mean_gap_s, seed=0):
    """Cumulative Poisson-process arrival offsets (seconds), seeded —
    bit-identical to the retired bench_extra._poisson_arrivals."""
    gaps = np.random.RandomState(seed).exponential(mean_gap_s, size=n)
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def _canon(obj):
    """JSON-safe canonical form: tuples -> lists, numpy scalars -> py."""
    if isinstance(obj, dict):
        return {str(k): _canon(v) for k, v in sorted(obj.items())}
    if isinstance(obj, (list, tuple)):
        return [_canon(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    return obj


class WorkloadSpec:
    """Declarative workload description. Grammar (all dicts JSON-safe;
    the reference's docs/capacity.md spells out every knob):

      arrival: {'process': 'poisson', 'mean_gap_s': g,
                ['burst': {'prob': p, 'size': m, 'jitter_s': j}]}
             | {'process': 'diurnal', 'mean_gap_s': g, 'period_s': T,
                'peak_to_trough': r}
             | {'process': 'burst'}                # everything at t=0
      lengths / output:
               {'dist': 'fixed', 'len': L}
             | {'dist': 'ladder', 'lens': [...]}   # round-robin ladder
             | {'dist': 'lognormal', 'median': M, 'sigma': s,
                'min': lo, 'max': hi}
             | {'dist': 'zipf', 'a': a, 'min': lo, 'max': hi}
      tenants: {'mode': 'round_robin' | 'weighted',
                'tenants': [{'name': n, ['weight': w],
                             ['lengths': {...}]}, ...]}
             | {'mode': 'zipf', 'count': K, 'a': a}
      models:  {'mode': 'zipf', 'count': K, 'a': a}   # 'model_%03d' names
             | {'mode': 'round_robin' | 'weighted',
                'models': [{'name': n, ['weight': w]}, ...]}
      prefix:  {'len': P, 'groups': G, 'prob': p}  # shared-prefix heads

    `lengths` draws the TAIL length when a request carries a shared
    prefix (prompt_tokens = prefix len + tail), matching the paged
    bench's shared-system-prompt workload.
    """

    def __init__(self, requests, seed=0, vocab_size=512, arrival=None,
                 lengths=None, output=None, tenants=None, prefix=None,
                 models=None):
        if requests < 1:
            raise ValueError('requests must be >= 1')
        self.requests = int(requests)
        self.seed = int(seed)
        self.vocab_size = int(vocab_size)
        self.arrival = dict(arrival or {'process': 'poisson',
                                        'mean_gap_s': 0.01})
        self.lengths = dict(lengths or {'dist': 'fixed', 'len': 16})
        self.output = dict(output or {'dist': 'fixed', 'len': 32})
        self.tenants = dict(tenants) if tenants else None
        self.prefix = dict(prefix) if prefix else None
        self.models = dict(models) if models else None

    def to_dict(self):
        d = {'requests': self.requests, 'seed': self.seed,
             'vocab_size': self.vocab_size,
             'arrival': self.arrival, 'lengths': self.lengths,
             'output': self.output, 'tenants': self.tenants,
             'prefix': self.prefix}
        # only when set: a single-model spec must hash identically to
        # specs serialized before the models knob existed, or every
        # stored bench best would silently orphan
        if self.models:
            d['models'] = self.models
        return _canon(d)

    @classmethod
    def from_dict(cls, d):
        return cls(requests=d['requests'], seed=d.get('seed', 0),
                   vocab_size=d.get('vocab_size', 512),
                   arrival=d.get('arrival'), lengths=d.get('lengths'),
                   output=d.get('output'), tenants=d.get('tenants'),
                   prefix=d.get('prefix'), models=d.get('models'))

    def canonical_json(self):
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(',', ':'))

    @property
    def hash(self):
        """12-hex content hash naming the trace exactly — the value
        bench rows record as `workload_spec`."""
        return hashlib.sha256(
            self.canonical_json().encode('utf-8')).hexdigest()[:12]

    def generate(self):
        return generate(self)

    def __repr__(self):
        return 'WorkloadSpec(%s)' % self.canonical_json()


# ---------------------------------------------------------------------------
# generation


def _gen_arrivals(spec):
    n, cfg = spec.requests, spec.arrival
    proc = cfg.get('process', 'poisson')
    if proc == 'burst':
        return np.zeros(n, dtype=np.float64)
    if proc == 'poisson':
        arr = poisson_arrivals(n, float(cfg['mean_gap_s']), spec.seed)
        burst = cfg.get('burst')
        if burst:
            # correlated bursts: selected requests re-anchor onto the
            # most recent organic arrival (plus jitter) — the thundering
            # herd shape a mean-rate Poisson process can never produce
            rng = np.random.RandomState(_stream_seed(spec.seed, 'burst'))
            mask = rng.rand(n) < float(burst.get('prob', 0.0))
            mask[0] = False
            anchor = np.maximum.accumulate(
                np.where(~mask, np.arange(n), 0))
            jitter = float(burst.get('jitter_s', 0.0)) * rng.rand(n)
            arr = np.where(mask, arr[anchor] + jitter, arr)
            arr = np.sort(arr, kind='stable')
        return arr
    if proc == 'diurnal':
        # rate(t) = base * (1 + amp*sin(2*pi*t/T)); amp chosen so
        # peak/trough rate ratio equals the requested value. Sequential
        # because each gap depends on the modulated rate at its start.
        mean_gap = float(cfg['mean_gap_s'])
        period = float(cfg['period_s'])
        ratio = float(cfg.get('peak_to_trough', 4.0))
        amp = (ratio - 1.0) / (ratio + 1.0)
        base_rate = 1.0 / mean_gap
        draws = np.random.RandomState(spec.seed).exponential(1.0, size=n)
        arr = np.empty(n, dtype=np.float64)
        t = 0.0
        for i in range(n):
            arr[i] = t
            rate = base_rate * (1.0 + amp * math.sin(_TWO_PI * t / period))
            t += draws[i] / max(rate, 1e-12 * base_rate)
        return arr
    raise ValueError('unknown arrival process %r' % (proc,))


def _gen_lengths(cfg, n, rng, counters=None, key=None):
    """Length array for one distribution. `ladder`/`fixed` consume no
    RNG (bench parity); heavy-tailed dists draw from `rng`."""
    dist = cfg.get('dist', 'fixed')
    if dist == 'fixed':
        return np.full(n, int(cfg['len']), dtype=np.int64)
    if dist == 'ladder':
        lens = np.asarray([int(x) for x in cfg['lens']], dtype=np.int64)
        if counters is None:
            return lens[np.arange(n) % len(lens)]
        # per-tenant ladder position: requests of the same tenant walk
        # the ladder in their own submission order
        out = np.empty(n, dtype=np.int64)
        for j in range(n):
            c = counters.get(key, 0)
            out[j] = lens[c % len(lens)]
            counters[key] = c + 1
        return out
    lo = int(cfg.get('min', 1))
    hi = cfg.get('max')
    if dist == 'lognormal':
        vals = rng.lognormal(math.log(float(cfg['median'])),
                             float(cfg.get('sigma', 0.6)), size=n)
        out = np.rint(vals).astype(np.int64)
    elif dist == 'zipf':
        out = rng.zipf(float(cfg.get('a', 1.3)), size=n) + lo - 1
    else:
        raise ValueError('unknown length dist %r' % (dist,))
    out = np.maximum(out, lo)
    if hi is not None:
        out = np.minimum(out, int(hi))
    return out


def _gen_tenants(spec):
    """(tenant_names tuple, tenant_id array, per-tenant length cfgs)."""
    n, cfg = spec.requests, spec.tenants
    if not cfg:
        return (None,), np.zeros(n, dtype=np.int64), {}
    mode = cfg.get('mode', 'round_robin')
    if mode == 'zipf':
        count = int(cfg['count'])
        names = tuple('tenant_%03d' % i for i in range(count))
        rng = np.random.RandomState(_stream_seed(spec.seed, 'tenant'))
        tid = np.minimum(rng.zipf(float(cfg.get('a', 1.2)), size=n) - 1,
                         count - 1).astype(np.int64)
        return names, tid, {}
    entries = list(cfg['tenants'])
    names = tuple(e['name'] for e in entries)
    per_len = {i: e['lengths'] for i, e in enumerate(entries)
               if e.get('lengths')}
    if mode == 'round_robin':
        tid = np.arange(n, dtype=np.int64) % len(names)
    elif mode == 'weighted':
        w = np.asarray([float(e.get('weight', 1.0)) for e in entries])
        rng = np.random.RandomState(_stream_seed(spec.seed, 'tenant'))
        tid = rng.choice(len(names), size=n, p=w / w.sum())
        tid = tid.astype(np.int64)
    else:
        raise ValueError('unknown tenant mode %r' % (mode,))
    return names, tid, per_len


def _gen_models(spec):
    """(model_names tuple or None, model_id array). Own RNG stream
    ('model') so adding a model mix never shifts tenant/length draws —
    the same discipline as every other knob."""
    n, cfg = spec.requests, getattr(spec, 'models', None)
    if not cfg:
        return None, np.zeros(n, dtype=np.int64)
    mode = cfg.get('mode', 'zipf')
    if mode == 'zipf':
        count = int(cfg['count'])
        names = tuple('model_%03d' % i for i in range(count))
        rng = np.random.RandomState(_stream_seed(spec.seed, 'model'))
        mid = np.minimum(rng.zipf(float(cfg.get('a', 1.2)), size=n) - 1,
                         count - 1).astype(np.int64)
        return names, mid
    entries = list(cfg['models'])
    names = tuple(e['name'] for e in entries)
    if mode == 'round_robin':
        mid = np.arange(n, dtype=np.int64) % len(names)
    elif mode == 'weighted':
        w = np.asarray([float(e.get('weight', 1.0)) for e in entries])
        rng = np.random.RandomState(_stream_seed(spec.seed, 'model'))
        mid = rng.choice(len(names), size=n, p=w / w.sum())
        mid = mid.astype(np.int64)
    else:
        raise ValueError('unknown model mode %r' % (mode,))
    return names, mid


def generate(spec):
    """Spec -> Trace. Columnar and prompt-free: generating a
    million-request trace for the simulator takes well under a second
    and never allocates token arrays."""
    n = spec.requests
    arrival = _gen_arrivals(spec)
    names, tid, per_len = _gen_tenants(spec)
    model_names, mid = _gen_models(spec)

    len_rng = np.random.RandomState(_stream_seed(spec.seed, 'lengths'))
    if per_len:
        tails = np.empty(n, dtype=np.int64)
        counters = {}
        for t in range(len(names)):
            idx = np.nonzero(tid == t)[0]
            if not len(idx):
                continue
            cfg = per_len.get(t, spec.lengths)
            tails[idx] = _gen_lengths(cfg, len(idx), len_rng,
                                      counters=counters, key=t)
    else:
        tails = _gen_lengths(spec.lengths, n, len_rng)

    out_rng = np.random.RandomState(_stream_seed(spec.seed, 'output'))
    new_tokens = np.maximum(_gen_lengths(spec.output, n, out_rng), 1)

    group = np.full(n, -1, dtype=np.int64)
    prefix_len = np.zeros(n, dtype=np.int64)
    pfx = spec.prefix
    if pfx and int(pfx.get('len', 0)) > 0:
        groups = int(pfx.get('groups', 1))
        prob = float(pfx.get('prob', 1.0))
        if groups == 1 and prob >= 1.0:
            group[:] = 0              # no RNG: bench paged-rung parity
        else:
            rng = np.random.RandomState(_stream_seed(spec.seed, 'prefix'))
            hit = rng.rand(n) < prob
            group = np.where(hit, rng.randint(0, groups, size=n), -1)
        prefix_len = np.where(group >= 0, int(pfx['len']), 0)

    order = np.argsort(arrival, kind='stable')
    return Trace(arrival=arrival[order],
                 prompt_len=(tails + prefix_len)[order],
                 new_tokens=new_tokens[order], tenant_id=tid[order],
                 tenant_names=names, prefix_group=group[order],
                 prefix_len=prefix_len[order],
                 model_id=mid[order], model_names=model_names,
                 meta={'spec': spec.to_dict(), 'spec_hash': spec.hash,
                       'vocab_size': spec.vocab_size, 'source': 'spec'})


# ---------------------------------------------------------------------------
# the Trace form


class Trace:
    """Columnar request trace, sorted by arrival time. Arrival times are
    relative seconds (t=0 is the first request). prompt_len is the TOTAL
    prompt length (shared prefix included)."""

    def __init__(self, arrival, prompt_len, new_tokens, tenant_id,
                 tenant_names, prefix_group, prefix_len, meta=None,
                 model_id=None, model_names=None):
        self.arrival = np.asarray(arrival, dtype=np.float64)
        self.prompt_len = np.asarray(prompt_len, dtype=np.int64)
        self.new_tokens = np.asarray(new_tokens, dtype=np.int64)
        self.tenant_id = np.asarray(tenant_id, dtype=np.int64)
        self.tenant_names = tuple(tenant_names)
        self.prefix_group = np.asarray(prefix_group, dtype=np.int64)
        self.prefix_len = np.asarray(prefix_len, dtype=np.int64)
        # model_names None == single-model trace (every request targets
        # the deployment default); model_id is then all zeros
        self.model_names = tuple(model_names) if model_names else None
        self.model_id = (np.asarray(model_id, dtype=np.int64)
                         if model_id is not None
                         else np.zeros(len(self.arrival), dtype=np.int64))
        self.meta = dict(meta or {})
        self._prompts = None

    def __len__(self):
        return int(len(self.arrival))

    @property
    def duration_s(self):
        return float(self.arrival[-1]) if len(self.arrival) else 0.0

    @property
    def spec_hash(self):
        return self.meta.get('spec_hash')

    def arrivals(self):
        return [float(t) for t in self.arrival]

    def tenants(self):
        names = self.tenant_names
        return [names[t] for t in self.tenant_id]

    def tenant_mix(self):
        mix = {}
        for t in self.tenant_id:
            name = self.tenant_names[t]
            mix[name] = mix.get(name, 0) + 1
        return mix

    def models(self):
        """Per-request model names, or None for a single-model trace."""
        if self.model_names is None:
            return None
        names = self.model_names
        return [names[m] for m in self.model_id]

    def model_mix(self):
        if self.model_names is None:
            return {}
        mix = {}
        for m in self.model_id:
            name = self.model_names[m]
            mix[name] = mix.get(name, 0) + 1
        return mix

    def prompts(self, vocab_size=None):
        """Materialize prompt token ids (cached). Drawn strictly in
        request order from RandomState(seed), shared prefixes at first
        use — the exact draw order of the historical bench generators,
        so replay prompts match the retired hand-rolled ones token for
        token."""
        if self._prompts is not None:
            return self._prompts
        vocab = int(vocab_size or self.meta.get('vocab_size') or 512)
        seed = int(self.meta.get('spec', {}).get('seed', 0))
        rng = np.random.RandomState(seed)
        heads = {}
        prompts = []
        for i in range(len(self)):
            g = int(self.prefix_group[i])
            head = []
            if g >= 0:
                if g not in heads:
                    heads[g] = [int(t) for t in rng.randint(
                        0, vocab, int(self.prefix_len[i]))]
                head = heads[g]
            tail_n = int(self.prompt_len[i]) - len(head)
            prompts.append(head + [int(t) for t in
                                   rng.randint(0, vocab, tail_n)])
        self._prompts = prompts
        return prompts

    # -- serialization ------------------------------------------------------

    def to_jsonl(self):
        """Canonical JSONL: one meta line, then one wide-event-named
        line per request. Byte-deterministic for a given trace (the
        determinism the tests pin)."""
        lines = [json.dumps({'trace_meta': _canon(self.meta)},
                            sort_keys=True, separators=(',', ':'))]
        names = self.tenant_names
        for i in range(len(self)):
            row = {'request_id': i, 'arrival_t': float(self.arrival[i]),
                   'tenant': names[self.tenant_id[i]],
                   'prompt_tokens': int(self.prompt_len[i]),
                   'output_tokens': int(self.new_tokens[i]),
                   'prefix_group': int(self.prefix_group[i]),
                   'prefix_len': int(self.prefix_len[i])}
            # only multi-model traces carry the column — single-model
            # JSONL stays byte-identical to pre-models output
            if self.model_names is not None:
                row['model'] = self.model_names[self.model_id[i]]
            lines.append(json.dumps(row, sort_keys=True,
                                    separators=(',', ':')))
        return '\n'.join(lines) + '\n'

    @classmethod
    def from_jsonl(cls, text):
        meta, rows = {}, []
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if not isinstance(obj, dict):
                continue
            if 'trace_meta' in obj:
                meta = obj['trace_meta'] or {}
            elif 'arrival_t' in obj:
                rows.append(obj)
        return _rows_to_trace(rows, meta)


def _rows_to_trace(rows, meta):
    if not rows:
        raise ValueError('no trace rows found')
    rows.sort(key=lambda r: (float(r.get('arrival_t') or 0.0)))
    t0 = float(rows[0].get('arrival_t') or 0.0)
    names, name_idx = [], {}
    mnames, mname_idx = [], {}
    multi_model = any(r.get('model') is not None for r in rows)
    tid = np.empty(len(rows), dtype=np.int64)
    mid = np.zeros(len(rows), dtype=np.int64)
    arrival = np.empty(len(rows), dtype=np.float64)
    plen = np.empty(len(rows), dtype=np.int64)
    ntok = np.empty(len(rows), dtype=np.int64)
    group = np.empty(len(rows), dtype=np.int64)
    pfx = np.empty(len(rows), dtype=np.int64)
    for i, r in enumerate(rows):
        t = r.get('tenant')
        if t not in name_idx:
            name_idx[t] = len(names)
            names.append(t)
        tid[i] = name_idx[t]
        if multi_model:
            m = r.get('model')
            if m not in mname_idx:
                mname_idx[m] = len(mnames)
                mnames.append(m)
            mid[i] = mname_idx[m]
        arrival[i] = float(r.get('arrival_t') or 0.0) - t0
        plen[i] = max(1, int(r.get('prompt_tokens') or 1))
        ntok[i] = max(1, int(r.get('output_tokens') or 1))
        group[i] = int(r.get('prefix_group', -1))
        pfx[i] = int(r.get('prefix_len', 0) or 0)
    return Trace(arrival=arrival, prompt_len=plen, new_tokens=ntok,
                 tenant_id=tid, tenant_names=tuple(names),
                 prefix_group=group, prefix_len=pfx,
                 model_id=mid if multi_model else None,
                 model_names=tuple(mnames) if multi_model else None,
                 meta=meta)


def trace_from_events(events, meta=None):
    """Recorded wide events (RequestLog.events() dicts / sink lines) ->
    Trace. Events without an arrival_t are skipped (they never entered
    the system); arrivals rebase to t=0. Prefix-group identity is not
    recoverable from a recorded event (only the hit count is), so
    loaded traces carry no shared-prefix structure. Time-range slicing
    belongs upstream: RequestLog.events(since_ts=..., until_ts=...)."""
    rows = [e for e in events
            if isinstance(e, dict) and e.get('arrival_t') is not None]
    if not rows:
        raise ValueError('no wide events with arrival_t')
    m = dict(meta or {})
    m.setdefault('source', 'events')
    return _rows_to_trace(
        [{'arrival_t': e['arrival_t'], 'tenant': e.get('tenant'),
          'model': e.get('model'),
          'prompt_tokens': e.get('prompt_tokens'),
          'output_tokens': e.get('output_tokens')} for e in rows], m)


def load_trace(path=None, text=None):
    """Trace from a file or captured text: accepts trace JSONL
    (to_jsonl output), a RequestLog JSONL sink, or dryrun captures with
    `request_event(N)[tag]: {json}` lines — whichever the content turns
    out to be."""
    if path is not None:
        with open(path, errors='replace') as f:
            text = f.read()
    if not text:
        raise ValueError('load_trace needs a path or text')
    from ..monitor.events import parse_event_lines
    embedded = [ev for _, ev in parse_event_lines(text)]
    if embedded:
        return trace_from_events(embedded)
    rows, meta, saw_event = [], {}, False
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if not isinstance(obj, dict):
            continue
        if 'trace_meta' in obj:
            meta = obj['trace_meta'] or {}
        elif 'request_id' in obj and 'finish_t' in obj:
            saw_event = True
            rows.append(obj)
        elif 'arrival_t' in obj:
            rows.append(obj)
    if saw_event:
        return trace_from_events(rows, meta=meta)
    return _rows_to_trace(rows, meta)
