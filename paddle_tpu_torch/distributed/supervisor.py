"""Elastic training supervisor: preemption-aware checkpoints, exactly-once
resume, and supervised recovery of stateful PS/graph shards (counterpart
of paddle_tpu/distributed/supervisor.py).

``TrainingSupervisor``
    Rides inside ``Model.fit(supervisor=...)``. Writes periodic
    checkpoints through ``CheckpointManager`` (atomic + manifest via
    io_save) that capture params, optimizer state AND a full
    ``ResumeCursor`` — epoch, step, global step, plus the RNG streams
    (global numpy and ``framework.random``'s torch CPU and CUDA states)
    at BOTH the epoch start and the checkpoint instant. The epoch-start
    capture replays the data loader's shuffle (``RandomSampler`` draws
    its permutation from the global numpy RNG when the iterator is
    built); the checkpoint-time capture re-seats compute RNG mid-epoch.
    Together they make a resumed run bit-identical to an uninterrupted
    one. A ``PreemptionWatcher`` turns SIGTERM into an urgent checkpoint
    at the next step boundary followed by a clean ``Preempted`` stop.

``PushJournal``
    Client-side exactly-once write journal. Every journaled PS/graph
    push records an entry and gets a monotonically increasing ``seq``;
    servers remember the highest applied seq per ``client_id`` and
    drop duplicates (``journal_apply`` in embedding_service /
    graph_service), so a retry or a post-recovery replay applies each
    write at most once. Entries are retained until a snapshot barrier
    vouches for them (``trim``).

``ShardSupervisor``
    Heartbeats stateful shards (EmbeddingServer / GraphPyServer) over
    their ``ping`` op, snapshots them at checkpoint barriers, and walks
    an escalation ladder when a shard goes quiet: restart (bounded
    attempts with backoff) -> restore newest valid snapshot + replay
    client journals -> abort with ``SupervisorAbort``. Recovery runs
    under a ``supervisor.recover`` span and feeds the ``supervisor_*``
    metric families (MTTR histogram, restart/escalation counters,
    shards-alive gauge), and dumps the tracer's flight recorder on
    recovery and on abort (``supervisor_recover`` / ``supervisor_abort``).
"""
import os
import re
import signal
import threading
import time

import numpy as np

from ..framework import random as _random
from ..framework.io_save import manifest_path, verify_checkpoint
from ..monitor import tracing as _tracing
from ..monitor.registry import default_registry
from ..monitor.telemetry import record_supervisor_schema
from . import resilience
from .checkpoint import CheckpointManager, _to_arrays

__all__ = ['Preempted', 'SupervisorAbort', 'ResumeCursor',
           'PreemptionWatcher', 'PushJournal', 'TrainingSupervisor',
           'ShardSpec', 'ShardSupervisor']


class Preempted(Exception):
    """Raised out of the training step loop after a preemption notice was
    honored with an urgent checkpoint; ``Model.fit`` treats it as a clean
    stop (``stop_training``), not an error."""


class SupervisorAbort(RuntimeError):
    """The shard supervisor's escalation ladder ran out (restart budget
    exhausted, or restore/replay failed)."""


class ResumeCursor:
    """Deterministic restart coordinates for a ``Model.fit`` run.

    ``epoch``/``step``/``global_step`` count COMPLETED work: the cursor
    says "epoch e, first `step` batches done, `global_step` batches done
    overall". ``epoch_rng`` is the RNG capture from the top of epoch e
    (before the loader iterator was built — replaying it re-draws the
    identical shuffle permutation); ``rng`` is the capture at the
    checkpoint instant (re-seated after fast-forwarding the loader).
    ``ingest`` is the attached streaming pipeline's ``IngestCursor``
    state dict when training reads from ``data.IngestPipeline`` — resume
    then SEEKS the stream instead of draining the trained prefix.
    """

    def __init__(self, epoch=0, step=0, global_step=0, epoch_rng=None,
                 rng=None, ingest=None):
        self.epoch = int(epoch)
        self.step = int(step)
        self.global_step = int(global_step)
        self.epoch_rng = epoch_rng
        self.rng = rng
        self.ingest = ingest

    @staticmethod
    def capture_rng():
        """Both host-side RNG streams training consumes: the global numpy
        RNG (data-loader shuffles) and framework.random's state (torch's
        default CPU generator and, once CUDA is initialised, every
        device's default CUDA generator: dropout without a generator)."""
        return {'numpy': np.random.get_state(),
                'paddle': _random.get_rng_state()}

    @staticmethod
    def restore_rng(state):
        np.random.set_state(state['numpy'])
        _random.set_rng_state(state['paddle'])

    def to_state(self):
        return {'epoch': self.epoch, 'step': self.step,
                'global_step': self.global_step,
                'epoch_rng': self.epoch_rng, 'rng': self.rng,
                'ingest': self.ingest}

    @classmethod
    def from_state(cls, state):
        return cls(epoch=state['epoch'], step=state['step'],
                   global_step=state['global_step'],
                   epoch_rng=state.get('epoch_rng'),
                   rng=state.get('rng'),
                   ingest=state.get('ingest'))

    def __repr__(self):
        return ('ResumeCursor(epoch=%d, step=%d, global_step=%d)'
                % (self.epoch, self.step, self.global_step))


class PreemptionWatcher:
    """Turns a preemption notice (SIGTERM by default, or a programmatic
    ``request()``) into a flag the supervisor checks at every step
    boundary. Signal handlers only set an Event, so the notice is
    async-signal-safe; all checkpoint work happens on the training
    thread."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._flag = threading.Event()
        self._signals = tuple(signals)
        self._prev = {}

    def install(self):
        for sig in self._signals:
            self._prev[sig] = signal.signal(sig, self._on_signal)
        return self

    def uninstall(self):
        prev, self._prev = self._prev, {}
        for sig, handler in prev.items():
            signal.signal(sig, handler)

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()

    def _on_signal(self, signum, frame):
        self._flag.set()

    def request(self):
        """Programmatic preemption notice (tests, metadata watchers)."""
        self._flag.set()

    def requested(self):
        return self._flag.is_set()

    def clear(self):
        self._flag.clear()


class PushJournal:
    """Client-side write journal backing exactly-once PS/graph pushes.

    Hand one to ``EmbeddingClient(journal=...)`` / ``GraphPyClient
    (journal=...)``: every push records its payload here first and is
    sent tagged ``(client_id, seq)``. Servers keep the highest applied
    seq per client and drop anything at or below it, so retries and
    post-recovery replays are idempotent end to end. ``trim()`` runs at
    snapshot barriers — once a server snapshot vouches for a prefix of
    the journal, those entries can never need replaying again.
    """

    def __init__(self, client_id, registry=None):
        self.client_id = str(client_id)
        self._entries = []            # [(seq, entry)] oldest-first
        self._seq = 0
        self._lock = threading.Lock()
        fams = record_supervisor_schema(
            registry if registry is not None else default_registry())
        self._m_replays = fams['supervisor_journal_replays_total']
        self._m_dedup = fams['supervisor_journal_dedup_hits_total']
        self.replayed = 0
        self.dedup_hits = 0

    @property
    def seq(self):
        """Highest seq handed out so far."""
        with self._lock:
            return self._seq

    def record(self, entry):
        """Append `entry` and return its seq (first seq is 1)."""
        with self._lock:
            self._seq += 1
            self._entries.append((self._seq, entry))
            return self._seq

    def entries(self):
        """Untrimmed [(seq, entry)] oldest-first — the replay set."""
        with self._lock:
            return list(self._entries)

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def trim(self, up_to_seq=None):
        """Drop entries with seq <= up_to_seq (default: everything
        recorded so far). Call ONLY at a snapshot barrier with no pushes
        in flight — a trimmed entry is unrecoverable if no snapshot
        covers it."""
        with self._lock:
            cut = self._seq if up_to_seq is None else int(up_to_seq)
            self._entries = [(s, e) for s, e in self._entries if s > cut]

    def note_replay(self):
        self.replayed += 1
        self._m_replays.inc()

    def note_dedup(self):
        """A journaled push came back ``applied=False`` — the server had
        already applied this seq (retry of an acked-but-lost reply, or a
        replay overlapping the snapshot)."""
        self.dedup_hits += 1
        self._m_dedup.inc()


class TrainingSupervisor:
    """Checkpoint/resume controller for ``Model.fit(supervisor=...)``.

    Lifecycle inside fit: ``restore(model)`` before the epoch loop (loads
    the newest valid checkpoint and yields the cursor), ``begin_epoch``
    at each epoch top BEFORE the loader iterator is built,
    ``fast_forward(data_iter)`` right after building the resumed epoch's
    iterator, ``on_step`` after every completed step (may write a
    periodic checkpoint, or honor a preemption notice by writing an
    urgent one and raising ``Preempted``). With a ``shard_supervisor``,
    every periodic checkpoint is also a snapshot barrier of its shards
    (``snapshot_shards``).
    """

    def __init__(self, directory, save_every_steps=0, keep_last=3,
                 watcher=None, shard_supervisor=None,
                 snapshot_shards=True, registry=None):
        self.manager = CheckpointManager(directory, keep_last=keep_last)
        self.save_every_steps = int(save_every_steps)
        self.watcher = watcher
        self.shards = shard_supervisor
        self.snapshot_shards = bool(snapshot_shards)
        fams = record_supervisor_schema(
            registry if registry is not None else default_registry())
        self._m_ckpts = fams['supervisor_checkpoints_total']
        self._m_preempt = fams['supervisor_preemptions_total']
        self._epoch_rng = None
        self._cursor = None           # pending resume cursor
        self._pipeline = None         # attached data.IngestPipeline
        self.last_saved_step = None

    def attach_pipeline(self, pipeline):
        """Register the streaming pipeline feeding the supervised fit:
        checkpoints then embed its exact stream cursor, and resume SEEKS
        the pipeline (shard/record/shuffle-window position) instead of
        draining the trained prefix through ``fast_forward``."""
        self._pipeline = pipeline
        return pipeline

    # -- checkpoint side ----------------------------------------------------
    def _state_dict(self, model, cursor):
        state = {'network': _to_arrays(dict(model.network.state_dict())),
                 'cursor': cursor.to_state()}
        if model._optimizer is not None:
            state['optimizer'] = _to_arrays(model._optimizer.state_dict())
        return state

    def save(self, model, epoch, step, global_step, kind='periodic'):
        """Write a checkpoint capturing model + optimizer + cursor. The
        cursor's RNG pair is captured HERE — at a step boundary — so a
        resumed run re-enters the exact RNG stream."""
        ingest = None
        if self._pipeline is not None:
            ingest = self._pipeline.cursor().to_state()
        cursor = ResumeCursor(epoch=epoch, step=step,
                              global_step=global_step,
                              epoch_rng=self._epoch_rng,
                              rng=ResumeCursor.capture_rng(),
                              ingest=ingest)
        self.manager.save(global_step, self._state_dict(model, cursor))
        self._m_ckpts.labels(kind).inc()
        self.last_saved_step = global_step
        if self.shards is not None and self.snapshot_shards \
                and kind == 'periodic':
            # snapshot barrier: fit() is between steps, no pushes are in
            # flight, so shard snapshots vouch for the whole journal and
            # the journals trim. Urgent (preemption) saves skip this —
            # the shards outlive this pod and keep their own state.
            self.shards.snapshot_all()
        return cursor

    # -- resume side --------------------------------------------------------
    def restore(self, model):
        """Load the newest valid checkpoint into `model` and stage its
        cursor for ``begin_epoch``/``fast_forward``. Returns the cursor,
        or None for a cold start."""
        step, state = self.manager.restore_latest()
        if state is None:
            self._cursor = None
            return None
        model.network.load_state_dict(state['network'])
        if model._optimizer is not None and 'optimizer' in state:
            model._optimizer.set_state_dict(state['optimizer'])
        self._cursor = ResumeCursor.from_state(state['cursor'])
        if self._cursor.ingest is not None and self._pipeline is not None:
            # stage the seek NOW: the pipeline's next __iter__ resumes
            # at the exact stream position, so fast_forward won't drain
            self._pipeline.restore(self._cursor.ingest)
        return self._cursor

    def begin_epoch(self, epoch):
        """Epoch top, BEFORE ``iter(train_loader)``. On the resumed
        epoch this re-seats the epoch-start RNG so the loader re-draws
        the interrupted epoch's exact permutation; on any other epoch it
        captures the current state for future cursors."""
        if self._cursor is not None and epoch == self._cursor.epoch:
            ResumeCursor.restore_rng(self._cursor.epoch_rng)
            self._epoch_rng = self._cursor.epoch_rng
        else:
            self._epoch_rng = ResumeCursor.capture_rng()

    def fast_forward(self, data_iter):
        """Drain the already-trained prefix of the resumed epoch from
        `data_iter`, then seat the checkpoint-instant RNG. Returns the
        number of batches skipped (the resumed epoch's starting step)."""
        cursor, self._cursor = self._cursor, None
        if cursor is None:
            return 0
        if cursor.ingest is None or self._pipeline is None:
            # plain loaders re-shuffle from epoch_rng, so the trained
            # prefix must be drained to reach the right position
            for _ in range(cursor.step):
                next(data_iter)
        # pipelines were staged in restore(): their iterator is already
        # seeking to cursor.ingest — nothing to drain
        if cursor.rng is not None:
            ResumeCursor.restore_rng(cursor.rng)
        return cursor.step

    def on_step(self, model, epoch, step, global_step):
        """After every completed step. Raises ``Preempted`` after the
        urgent checkpoint when a preemption notice is pending."""
        if self.watcher is not None and self.watcher.requested():
            self.watcher.clear()
            self.save(model, epoch, step, global_step, kind='urgent')
            self._m_preempt.inc()
            raise Preempted('preemption honored at epoch %d step %d '
                            '(global step %d): urgent checkpoint written'
                            % (epoch, step, global_step))
        if self.save_every_steps and \
                global_step % self.save_every_steps == 0:
            self.save(model, epoch, step, global_step, kind='periodic')


class ShardSpec:
    """One supervised stateful shard.

    restart: nullary callable that rebinds the shard's service (e.g.
    constructs a fresh EmbeddingServer on the same port). May return a
    new ``endpoint`` string if the rebind moved; returning None keeps
    the current one. clients: client objects exposing
    ``replay_journal()`` and ``.journal`` (EmbeddingClient /
    GraphPyClient built with a PushJournal) — replayed after a restore,
    trimmed at snapshot barriers.
    """

    def __init__(self, name, endpoint, role='ps', restart=None,
                 snapshot_dir=None, clients=(), keep_snapshots=2):
        self.name = str(name)
        self.endpoint = endpoint
        self.role = str(role)
        self.restart = restart
        self.snapshot_dir = snapshot_dir
        self.clients = tuple(clients)
        self.keep_snapshots = max(int(keep_snapshots), 1)


class _ShardState:
    def __init__(self, spec):
        self.spec = spec
        self.misses = 0
        self.restarts = 0
        self.snap_seq = 0
        self.alive = True


class ShardSupervisor:
    """Liveness + recovery controller for PS/graph shards.

    ``poll()`` runs one synchronous heartbeat round (tests drive this
    directly); ``start(interval)`` runs it on a background thread. A
    shard that misses ``miss_threshold`` consecutive pings enters
    ``recover()``: restart with backoff (``restart_budget`` attempts),
    then restore the newest manifest-valid snapshot and replay every
    client journal, else abort with ``SupervisorAbort``.
    """

    _SNAP_RE = re.compile(r'_snap_(\d+)\.ckpt$')

    def __init__(self, miss_threshold=2, restart_budget=3, backoff=None,
                 ping_timeout=1.0, op_timeout=30.0, registry=None,
                 clock=time.monotonic):
        self.miss_threshold = int(miss_threshold)
        self.restart_budget = int(restart_budget)
        self._backoff = backoff if backoff is not None else \
            resilience.RetryPolicy(base_delay=0.05, max_delay=1.0,
                                   jitter=0.0)
        self.ping_timeout = float(ping_timeout)
        self.op_timeout = float(op_timeout)
        self._clock = clock
        fams = record_supervisor_schema(
            registry if registry is not None else default_registry())
        self._m_restarts = fams['supervisor_restarts_total']
        self._m_recover = fams['supervisor_recover_seconds']
        self._m_escalations = fams['supervisor_escalations_total']
        self._m_alive = fams['supervisor_shards_alive']
        self._shards = {}
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread = None
        self.abort_error = None

    # -- membership ---------------------------------------------------------
    def add_shard(self, spec):
        with self._lock:
            self._shards[spec.name] = _ShardState(spec)
        return spec

    def shard(self, name):
        return self._shards[name].spec

    def alive(self, name):
        return self._shards[name].alive

    # -- rpc helpers --------------------------------------------------------
    def _ping(self, spec):
        try:
            out = resilience.call_once(spec.endpoint, {'op': 'ping'},
                                       timeout=self.ping_timeout,
                                       connect_timeout=self.ping_timeout)
            return isinstance(out, dict) and bool(out.get('ok'))
        except Exception:
            return False

    # -- snapshot barrier ---------------------------------------------------
    def _snap_path(self, spec, seq):
        return os.path.join(spec.snapshot_dir,
                            '%s_snap_%06d.ckpt' % (spec.name, seq))

    def _snapshots(self, spec):
        """[(seq, path)] newest-first for this shard."""
        out = []
        try:
            names = os.listdir(spec.snapshot_dir)
        except (OSError, TypeError):
            return out
        prefix = spec.name + '_snap_'
        for n in names:
            m = self._SNAP_RE.search(n)
            if m and n.startswith(prefix):
                out.append((int(m.group(1)),
                            os.path.join(spec.snapshot_dir, n)))
        return sorted(out, reverse=True)

    def snapshot_all(self):
        """Snapshot every shard that has a snapshot_dir, then trim the
        client journals. MUST run at a barrier (no pushes in flight):
        the journal cut is taken before the snapshot RPCs, so every
        trimmed entry was already applied server-side and is covered by
        the snapshot. Any snapshot failure propagates BEFORE trimming —
        journals are never cut without a snapshot vouching for them."""
        with self._lock:
            cuts, seen = [], set()
            for st in self._shards.values():
                for c in st.spec.clients:
                    j = getattr(c, 'journal', None)
                    if j is not None and id(j) not in seen:
                        seen.add(id(j))
                        cuts.append((j, j.seq))
            paths = {}
            for st in self._shards.values():
                spec = st.spec
                if spec.snapshot_dir is None:
                    continue
                os.makedirs(spec.snapshot_dir, exist_ok=True)
                st.snap_seq += 1
                path = self._snap_path(spec, st.snap_seq)
                resilience.call_once(spec.endpoint,
                                     {'op': 'snapshot', 'path': path},
                                     timeout=self.op_timeout)
                paths[spec.name] = path
                for _, old in self._snapshots(spec)[spec.keep_snapshots:]:
                    for p in (old, manifest_path(old)):
                        try:
                            os.remove(p)
                        except OSError:
                            pass
            for j, cut in cuts:
                j.trim(cut)
            return paths

    # -- heartbeat ----------------------------------------------------------
    def poll(self):
        """One heartbeat round. Recovers (synchronously) any shard past
        the miss threshold. Returns {name: alive}."""
        with self._lock:
            out = {}
            for name, st in self._shards.items():
                if self._ping(st.spec):
                    st.misses = 0
                    st.alive = True
                else:
                    st.misses += 1
                    st.alive = False
                    if st.misses >= self.miss_threshold:
                        self.recover(name)
                out[name] = st.alive
            self._m_alive.set(sum(1 for a in out.values() if a))
            return out

    def start(self, interval=0.5):
        """Heartbeat on a background thread; a SupervisorAbort lands in
        ``self.abort_error`` and stops the loop."""
        with self._lock:
            if self._thread is not None:
                return
            self._stop.clear()

            def _loop():
                while not self._stop.wait(interval):
                    try:
                        self.poll()
                    except SupervisorAbort as e:
                        self.abort_error = e
                        break
            self._thread = threading.Thread(target=_loop, daemon=True,
                                            name='shard-supervisor')
            self._thread.start()

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10)

    # -- escalation ladder --------------------------------------------------
    def recover(self, name):
        """restart -> restore+replay -> abort. Returns MTTR seconds."""
        st = self._shards[name]
        spec = st.spec
        t0 = self._clock()
        tr = _tracing.default_tracer()
        with tr.start_span('supervisor.recover',
                           tags={'shard': name, 'role': spec.role}) as span:
            try:
                self._restart_stage(st, span)
                self._restore_stage(st, span)
            except SupervisorAbort:
                st.alive = False
                self._m_escalations.labels('abort').inc()
                if span:
                    span.set_tag('outcome', 'abort')
                tr.recorder.maybe_dump('supervisor_abort')
                raise
            st.alive = True
            st.misses = 0
            mttr = self._clock() - t0
            self._m_recover.observe(mttr)
            self._m_restarts.labels(spec.role).inc()
            if span:
                span.set_tag('outcome', 'recovered')
                span.set_tag('mttr_s', round(mttr, 6))
        tr.recorder.maybe_dump('supervisor_recover')
        return mttr

    def _restart_stage(self, st, span):
        spec = st.spec
        self._m_escalations.labels('restart').inc()
        last_err = None
        for attempt in range(1, self.restart_budget + 1):
            if spec.restart is not None:
                try:
                    new_ep = spec.restart()
                    if new_ep is not None:
                        spec.endpoint = new_ep
                except Exception as e:
                    last_err = e
                    time.sleep(self._backoff.backoff(attempt))
                    continue
            if self._ping(spec):
                st.restarts += 1
                if span:
                    span.add_event('restarted', attempt=attempt)
                return
            time.sleep(self._backoff.backoff(attempt))
        raise SupervisorAbort(
            'shard %r did not come back after %d restart attempts%s'
            % (spec.name, self.restart_budget,
               ': last error %s' % last_err if last_err else ''))

    def _restore_stage(self, st, span):
        """A restarted shard is blank: restore the newest manifest-valid
        snapshot, then replay every client journal — the journaled seqs
        make the replay exactly-once even where it overlaps the
        snapshot (the server dedups anything the snapshot covered)."""
        spec = st.spec
        self._m_escalations.labels('restore').inc()
        snap = None
        for _, path in self._snapshots(spec):
            # torn snapshots (writer died pre-manifest) are skipped, not
            # trusted — same rule as CheckpointManager.restore_latest
            if verify_checkpoint(path, require_manifest=True):
                snap = path
                break
        try:
            if snap is not None:
                resilience.call_once(spec.endpoint,
                                     {'op': 'restore', 'path': snap},
                                     timeout=self.op_timeout)
                if span:
                    span.add_event('restored',
                                   snapshot=os.path.basename(snap))
            replayed = dedup = 0
            for client in spec.clients:
                r, d = client.replay_journal()
                replayed += r
                dedup += d
            if span and (replayed or dedup):
                span.add_event('journal_replayed', entries=replayed,
                               dedup_hits=dedup)
        except Exception as e:
            raise SupervisorAbort('shard %r restore/replay failed: %s'
                                  % (spec.name, e))
