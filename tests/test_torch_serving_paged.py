"""The port's paged-KV host bookkeeping and engine lifecycle
(paddle_tpu_torch/serving/), mirroring tests/test_serving_paged.py and the
JAX package's host-side serving tests: page refcounts, prefix-cache
hashing and eviction, page-aware admission, the scheduler's chunk plan,
the metrics, allocator double-free strictness, FIFO fairness under full
occupancy, shutdown semantics, page-leak-free churn and priority
preemption with exact resumption. The model is a small GPT on the CPU.
"""
import threading

import numpy as np
import pytest

from paddle_tpu_torch.monitor import events as _events
from paddle_tpu_torch.serving import (ContinuousBatchingEngine, NGramProposer,
                                      PagedContinuousBatchingEngine,
                                      PagedScheduler, Scheduler,
                                      ServingMetrics, SlotAllocator)
from paddle_tpu_torch.serving.kv_cache import (SCRATCH_PAGE, PageAllocator,
                                               PrefixCache)
from paddle_tpu_torch.serving.metrics import percentile
from paddle_tpu_torch.serving.scheduler import Request
from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM


@pytest.fixture(scope='module')
def model():
    cfg = GPTConfig(vocab_size=211, hidden_size=64, num_layers=2,
                    num_heads=4, max_position_embeddings=128, dropout=0.0)
    return GPTForCausalLM(cfg, device='cpu', seed=7).eval()


# ---- allocators -------------------------------------------------------


def test_slot_allocator_double_free_raises():
    a = SlotAllocator(2)
    s = a.alloc('r0')
    a.free(s)
    with pytest.raises(ValueError, match='double-free'):
        a.free(s)
    with pytest.raises(ValueError, match='not allocated'):
        a.free(1)                       # never allocated
    # the raise must not corrupt the free list: both slots still usable
    assert sorted([a.alloc('r1'), a.alloc('r2')]) == [0, 1]
    assert a.alloc('r3') is None


def test_page_allocator_basics():
    a = PageAllocator(5)                # pages 1..4 allocatable
    assert a.alloc() == 1               # lowest-first, page 0 reserved
    assert a.alloc() == 2
    assert a.refcount(1) == 1
    assert a.in_use == 2 and a.available == 2
    assert a.occupancy == pytest.approx(0.5)
    assert a.decref(1) is True          # freed at zero
    assert a.alloc() == 1               # reuses the lowest freed page
    with pytest.raises(ValueError, match='num_pages'):
        PageAllocator(1)                # no room beyond the scratch page


def test_page_allocator_refcounts_and_double_free():
    a = PageAllocator(4)
    p = a.alloc()
    a.incref(p)                         # second owner (e.g. prefix cache)
    assert a.refcount(p) == 2
    assert a.decref(p) is False         # still held
    assert a.decref(p) is True          # last owner: back on free list
    with pytest.raises(ValueError, match='double-free'):
        a.decref(p)
    with pytest.raises(ValueError, match='not allocated'):
        a.incref(p)
    with pytest.raises(ValueError, match='scratch'):
        a.decref(SCRATCH_PAGE)
    with pytest.raises(ValueError, match='not allocated'):
        a.free(3)                       # never allocated


# ---- prefix cache -----------------------------------------------------


def test_prefix_cache_chain_match_and_publish():
    a = PageAllocator(16)
    pc = PrefixCache(4, a)
    prompt = list(range(11))            # blocks [0-3], [4-7]; tail 8-10
    assert pc.match(prompt) == []       # cold: both full blocks miss
    assert (pc.hits, pc.misses) == (0, 2)
    p0, p1 = a.alloc(), a.alloc()
    assert pc.publish(prompt, 0, p0)
    assert pc.publish(prompt, 1, p1)
    assert a.refcount(p0) == 2          # cache holds its own reference
    assert pc.match(prompt) == [p0, p1]
    # a whole-prompt-covering match is forbidden: >= 1 token must
    # prefill so the final chunk's logits can seed generation
    assert pc.match(prompt[:8]) == [p0]
    # chain hashing: same block content after a DIFFERENT prefix is a
    # different key — block 1's page must not leak to a mismatched head
    other = [99, 99, 99, 99] + prompt[4:]
    assert pc.match(other) == []
    # duplicate publish is a no-op and takes no extra reference
    assert not pc.publish(prompt, 0, p0)
    assert a.refcount(p0) == 2


def test_prefix_cache_evicts_lru_and_skips_referenced_pages():
    a = PageAllocator(16)
    pc = PrefixCache(2, a)
    prompts = [[i, i, 0, 0, 0] for i in range(3)]
    pages = []
    for pr in prompts:
        p = a.alloc()
        pc.publish(pr, 0, p)
        a.decref(p)                     # publisher retired: cache-only ref
        pages.append(p)
    pc.match(prompts[0])                # refresh entry 0: now most-recent
    a.incref(pages[1])                  # a live sequence maps entry 1
    assert pc.evict(2) == 2             # entry 2 (LRU) + entry 0
    assert len(pc) == 1                 # the referenced entry survived
    assert a.refcount(pages[1]) == 2
    assert pc.match(prompts[1]) == [pages[1]]
    pc.clear()
    a.decref(pages[1])
    assert a.in_use == 0 and a.available == 15


# ---- page-aware scheduling --------------------------------------------


def _mk_sched(num_seqs=2, num_pages=9, max_len=32, chunk=4, page=4,
              prefix=True):
    pages = PageAllocator(num_pages)
    pc = PrefixCache(page, pages) if prefix else None
    sched = PagedScheduler(SlotAllocator(num_seqs), pages, max_len, chunk,
                           page, pc)
    return sched, pages


def test_paged_scheduler_reserves_all_pages_up_front():
    sched, pages = _mk_sched()
    r = Request(list(range(6)), max_new_tokens=4)   # needs 9 rows -> 3 pages
    sched.submit(r)
    assert [req for _, req in sched.admit()] == [r]
    assert pages.in_use == 3
    row = sched.block_tables[r.slot]
    assert (row[:3] > SCRATCH_PAGE).all()
    assert (row[3:] == SCRATCH_PAGE).all()
    sched.mark_prefilled(r, 6)
    sched.retire(r)
    # full release: pages either free or held ONLY by the prefix cache
    assert pages.in_use == len(sched.prefix)
    assert (sched.block_tables[0] == SCRATCH_PAGE).all()


def test_paged_scheduler_head_blocking_keeps_fifo():
    sched, pages = _mk_sched(num_seqs=2, num_pages=9)
    big = Request(list(range(20)), max_new_tokens=9)    # 7 pages
    small = Request([1, 2], max_new_tokens=2)           # 1 page
    hog = Request(list(range(12)), max_new_tokens=5)    # 4 pages
    sched.submit(hog)
    assert len(sched.admit()) == 1
    sched.submit(big)
    sched.submit(small)
    # 5 pages remain: big (7) cannot reserve — and small must NOT jump
    # the queue past it, or big could starve behind a stream of smalls
    assert sched.admit() == []
    assert pages.in_use == 4
    sched.mark_prefilled(hog, 12)
    sched.retire(hog)
    admitted = [req for _, req in sched.admit()]
    assert admitted[0] is big                           # FIFO restored
    assert small in admitted


def test_paged_scheduler_submit_validation():
    sched, _ = _mk_sched(max_len=16, num_pages=5)
    with pytest.raises(ValueError, match='empty prompt'):
        sched.submit(Request([], max_new_tokens=2))
    with pytest.raises(ValueError, match='max_new_tokens'):
        sched.submit(Request([1], max_new_tokens=0))
    with pytest.raises(ValueError, match='cache rows'):
        sched.submit(Request(list(range(14)), max_new_tokens=8))
    with pytest.raises(ValueError, match='pages'):
        # fits max_len rows but not the 4-page pool
        _mk_sched(max_len=32, num_pages=5)[0].submit(
            Request(list(range(15)), max_new_tokens=14))


def test_paged_scheduler_1k_churn_leaks_no_pages():
    """The page-leak satellite, at the bookkeeping layer where 1000
    requests are cheap: after arbitrary admit/prefill/retire churn with
    prefix publishing on, every page is back on the free list except
    the prefix cache's own bounded references."""
    rng = np.random.RandomState(5)
    sched, pages = _mk_sched(num_seqs=4, num_pages=33, max_len=32)
    system = [7, 8, 9, 10]                      # one shareable block
    live = []
    for i in range(1000):
        n0 = int(rng.randint(1, 10))
        r = Request(system + [int(t) for t in rng.randint(0, 99, n0)],
                    max_new_tokens=int(rng.randint(1, 8)))
        sched.submit(r)
        for _, req in sched.admit():
            live.append(req)
        if live and rng.rand() < 0.7:
            req = live.pop(int(rng.randint(len(live))))
            sched.mark_prefilled(req, len(req.prompt))
            sched.retire(req)
    for req in live:
        sched.mark_prefilled(req, len(req.prompt))
        sched.retire(req)
    while sched.queue:
        for _, req in sched.admit():
            sched.mark_prefilled(req, len(req.prompt))
            sched.retire(req)
    assert pages.in_use == len(sched.prefix)
    sched.prefix.clear()
    assert pages.in_use == 0
    assert pages.available == 32
    assert (sched.block_tables == SCRATCH_PAGE).all()


# ---- engine lifecycle -------------------------------------------------


def test_engine_fifo_fairness_under_full_occupancy(model):
    """Sustained full occupancy with Poisson arrivals: admission is
    FIFO (no request overtakes an earlier one) and nobody starves —
    every request finishes within a wait bounded by the generation
    lengths ahead of it."""
    rng = np.random.RandomState(4)
    eng = PagedContinuousBatchingEngine(model, num_seqs=2, max_len=32,
                                        page_size=8, prefill_chunk=8,
                                        decode_block=4)
    admitted = []
    orig = eng.scheduler.admit
    eng.scheduler.admit = lambda: [
        (s, (admitted.append(r.id), r)[1]) for s, r in orig()]
    n_req, due = 12, [0] + list(np.cumsum(
        rng.poisson(1.0, size=11)))       # arrival step of each request
    prompts = [[int(t) for t in rng.randint(0, 211, 1 + i % 5)]
               for i in range(n_req)]
    reqs, i, steps = [], 0, 0
    while i < n_req or eng.scheduler.pending:
        while i < n_req and due[i] <= steps:
            reqs.append(eng.add_request(prompts[i], max_new_tokens=6))
            i += 1
        eng.step()
        steps += 1
        assert steps < 300              # no starvation: bounded total
    assert admitted == [r.id for r in reqs]          # FIFO, no overtakes
    assert all(len(r.tokens) == 6 for r in reqs)
    # load was sustained: most steps ran with some occupancy
    assert eng.metrics.report()['occupancy_mean'] > 0.25


@pytest.mark.parametrize('make', [
    lambda m: ContinuousBatchingEngine(m, num_slots=2, max_len=32,
                                       prefill_chunk=8, decode_block=2),
    lambda m: PagedContinuousBatchingEngine(m, num_seqs=2, max_len=32,
                                            page_size=8, prefill_chunk=8,
                                            decode_block=2),
], ids=['slot', 'paged'])
def test_shutdown_rejects_new_requests_but_drains(model, make):
    eng = make(model)
    req = eng.add_request([1, 2, 3], max_new_tokens=3)
    eng.shutdown()
    with pytest.raises(RuntimeError, match='shut down'):
        eng.add_request([4, 5], max_new_tokens=2)
    eng.run()                           # in-flight work still completes
    assert len(req.tokens) == 3
    assert eng.scheduler.pending == 0


@pytest.mark.parametrize('make', [
    lambda m: ContinuousBatchingEngine(m, num_slots=2, max_len=32,
                                       prefill_chunk=8, decode_block=2),
    lambda m: PagedContinuousBatchingEngine(m, num_seqs=2, max_len=32,
                                            page_size=8, prefill_chunk=8,
                                            decode_block=2),
], ids=['slot', 'paged'])
def test_shutdown_races_active_stream_consumers(model, make):
    """shutdown() lands WHILE stream() consumers are cooperatively
    driving the engine: the front door closes, but every consumer's
    stream still terminates cleanly with its full token budget (the
    retire/churn half of this contract is covered above)."""
    eng = make(model)
    reqs = [eng.add_request(p, max_new_tokens=6, stream=True)
            for p in ([1, 2, 3], [4, 5], [6, 7, 8, 9])]
    got = {i: [] for i in range(len(reqs))}
    errs = []

    def consume(i):
        try:
            for tok in eng.stream(reqs[i]):
                got[i].append(tok)
        except Exception as e:        # noqa: BLE001 — the assertion
            errs.append(e)

    threads = [threading.Thread(target=consume, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    eng.shutdown()                    # races the consumers' step() calls
    with pytest.raises(RuntimeError, match='shut down'):
        eng.add_request([1], max_new_tokens=2)
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert errs == []
    for i, r in enumerate(reqs):
        assert got[i] == r.tokens
        assert len(got[i]) == 6
    assert eng.scheduler.pending == 0


def test_engine_retire_releases_pages(model):
    """Engine-level leak check: after churning many requests through few
    sequences, only the prefix cache still references pages, and
    disabling it drains the pool to empty."""
    rng = np.random.RandomState(9)
    prompts = [[int(t) for t in rng.randint(0, 211, 1 + i % 7)]
               for i in range(12)]
    eng = PagedContinuousBatchingEngine(model, num_seqs=2, max_len=32,
                                        page_size=8, prefill_chunk=8,
                                        decode_block=2, prefix_cache=False)
    eng.generate(prompts, max_new_tokens=4)
    assert eng.pages.in_use == 0
    assert eng.pages.available == eng.num_pages - 1
    assert (eng.scheduler.block_tables == SCRATCH_PAGE).all()


# ---- speculative proposer ---------------------------------------------


def test_ngram_proposer():
    p = NGramProposer(2)
    # trailing bigram (3, 4) occurred earlier: propose its continuation
    assert p.propose([1, 3, 4, 7, 8, 3, 4], 3) == [7, 8, 3]
    # no earlier occurrence: repeat the last token
    assert p.propose([1, 2, 3], 2) == [3, 3]
    # continuation shorter than k: pad by repeating its last token
    assert p.propose([5, 6, 9, 5, 6], 4) == [9, 5, 6, 6]
    # single-token history cannot form an n-gram; still drafts k tokens
    assert p.propose([4], 3) == [4, 4, 4]
    with pytest.raises(ValueError):
        NGramProposer(0)


def test_paged_capacity_validation(model):
    with pytest.raises(ValueError, match='max_position_embeddings'):
        PagedContinuousBatchingEngine(model, num_seqs=2, max_len=4096)
    eng = PagedContinuousBatchingEngine(model, num_seqs=2, max_len=32,
                                        page_size=8, prefill_chunk=8,
                                        decode_block=2)
    with pytest.raises(ValueError, match='cache rows'):
        eng.add_request(list(range(30)), max_new_tokens=8)
    # capacity errors must not wedge later valid requests
    req = eng.add_request([1, 2, 3], max_new_tokens=2)
    eng.run()
    assert len(req.tokens) == 2


# ---- the slot scheduler and metrics (tests/test_serving.py) -----------


def test_slot_allocator():
    a = SlotAllocator(3)
    s0, s1 = a.alloc('r0'), a.alloc('r1')
    assert (s0, s1) == (0, 1)           # lowest-first, deterministic
    a.free(s0)
    assert a.alloc('r2') == 0           # reuse the lowest freed slot
    assert a.in_use == 2 and a.available == 1
    assert a.occupancy == pytest.approx(2 / 3)
    assert a.owner_of(1) == 'r1'
    with pytest.raises(ValueError):
        a.free(2)                       # never allocated
    assert a.alloc('r3') == 2
    assert a.alloc('r4') is None        # full


def test_scheduler_chunk_plan():
    a = SlotAllocator(2)
    s = Scheduler(a, max_len=32, prefill_chunk=8)
    r = Request(list(range(1, 12)), max_new_tokens=4)   # 11 tokens
    s.submit(r)
    assert s.admit() == [(0, r)]
    plan = s.prefill_plan()
    assert len(plan) == 1
    req, start, ids, valid, final = plan[0]
    assert (start, valid, final) == (0, 8, False)
    assert ids == list(range(1, 9))
    s.mark_prefilled(req, 8)
    req, start, ids, valid, final = s.prefill_plan()[0]
    assert (start, valid, final) == (8, 3, True)
    assert ids == [9, 10, 11, 0, 0, 0, 0, 0]            # zero-padded to C


def test_metrics_report():
    t = [0.0]
    m = ServingMetrics(clock=lambda: t[0])
    m.on_arrival('a')
    t[0] = 0.5
    m.on_tokens('a', 1)            # ttft 0.5s
    t[0] = 0.9
    m.on_tokens('a', 4)            # 0.4s burst over 4 tokens
    m.on_step(2, 4)
    m.on_step(4, 4)
    rep = m.report()
    assert rep['tokens'] == 5
    assert rep['tok_per_s'] == pytest.approx(5 / 0.9)
    assert rep['ttft_p50_ms'] == pytest.approx(500.0)
    assert rep['ttft_p99_ms'] == pytest.approx(500.0)
    assert rep['occupancy_mean'] == pytest.approx(0.75)
    assert rep['latency_p99_ms'] <= 500.0


@pytest.mark.parametrize('q', [0, 10, 33.3, 50, 90, 99, 100])
def test_percentile_is_linear_interpolation(q):
    assert percentile([], q) is None
    assert percentile([7.0], q) == 7.0
    vals = np.random.RandomState(0).rand(17).tolist()
    assert percentile(vals, q) == pytest.approx(float(np.percentile(vals, q)))
    assert percentile([1.0, 2.0, 4.0], 75) == pytest.approx(3.0)


def test_admission_validation(model):
    eng = ContinuousBatchingEngine(model, num_slots=2, max_len=32,
                                   prefill_chunk=8, decode_block=2)
    with pytest.raises(ValueError, match='empty prompt'):
        eng.add_request([], max_new_tokens=4)
    with pytest.raises(ValueError, match='max_new_tokens'):
        eng.add_request([1, 2], max_new_tokens=0)
    with pytest.raises(ValueError, match='cache rows'):
        eng.add_request(list(range(30)), max_new_tokens=8)   # 30+8-1 > 32
    # prompt + budget fit but the padded last prefill chunk would not
    eng30 = ContinuousBatchingEngine(model, num_slots=2, max_len=30,
                                     prefill_chunk=8, decode_block=2)
    with pytest.raises(ValueError, match='cache rows'):
        eng30.add_request(list(range(26)), max_new_tokens=2)
    req = eng.add_request([1, 2, 3], max_new_tokens=2)
    eng.run()
    assert len(req.tokens) == 2


@pytest.mark.parametrize('make', [
    lambda m: ContinuousBatchingEngine(m, num_slots=2, max_len=32,
                                       prefill_chunk=8, decode_block=2),
    lambda m: PagedContinuousBatchingEngine(m, num_seqs=2, max_len=32,
                                            page_size=8, prefill_chunk=8,
                                            decode_block=2),
], ids=['slot', 'paged'])
def test_front_door_rejects_unservable_worst_case(model, make):
    eng = make(model)
    with pytest.raises(ValueError, match='max_len=32'):
        eng.add_request(list(range(1, 20)), max_new_tokens=20)  # 38 > 32
    req = eng.add_request(list(range(1, 20)), max_new_tokens=14)  # == 32
    eng.run()
    assert len(req.tokens) == 14
    assert eng.scheduler.pending == 0


def test_engine_cap_exceeds_model_positions(model):
    with pytest.raises(ValueError, match='max_position_embeddings'):
        ContinuousBatchingEngine(model, num_slots=2, max_len=4096)


def test_engine_1k_request_churn_leaks_no_pages(model):
    """The engine itself (not just its scheduler) through 1000 short
    requests on 4 sequences and a 24-page pool, prefix publishing on:
    every page comes back to the free list or the prefix cache."""
    rng = np.random.RandomState(6)
    system = [5, 6, 7, 8, 9, 10, 11, 12]            # one shareable block
    eng = PagedContinuousBatchingEngine(model, num_seqs=4, max_len=32,
                                        page_size=8, num_pages=24,
                                        prefill_chunk=8, decode_block=2)
    reqs = [eng.add_request(
        (system if i % 2 else []) +
        [int(t) for t in rng.randint(0, 211, 1 + i % 5)],
        max_new_tokens=1 + i % 3) for i in range(1000)]
    eng.run()
    assert all(len(r.tokens) == 1 + i % 3 for i, r in enumerate(reqs))
    assert eng.pages.in_use == len(eng.prefix)
    assert (eng.scheduler.block_tables == SCRATCH_PAGE).all()
    eng.prefix.clear()
    assert eng.pages.in_use == 0


# ---- priority preemption (tests/test_qos.py) ---------------------------


@pytest.fixture()
def paged_preempt(model):
    log = _events.RequestLog(capacity=256)
    prev = _events.set_default_request_log(log)
    eng = PagedContinuousBatchingEngine(
        model, num_seqs=2, max_len=32, page_size=8, prefill_chunk=8,
        decode_block=2, preempt=True)
    yield eng, log
    _events.set_default_request_log(prev)


def _events_for(log, rid):
    return [e for e in log.events() if e['request_id'] == rid]


PREEMPT_PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6, 5, 3, 5], [8, 9, 7, 9]]


def test_preempt_resume_exact_token_parity(paged_preempt):
    eng, log = paged_preempt
    mnt = 8
    # uniform priorities never preempt: the engine is its own oracle
    ref = eng.generate(PREEMPT_PROMPTS, max_new_tokens=mnt)
    reg = eng.metrics.registry
    pre0 = reg.get('qos_preempted_total').labels('lo').value()
    base = eng.scheduler.preempted
    r0 = eng.add_request(PREEMPT_PROMPTS[0], max_new_tokens=mnt,
                         tenant='lo', priority=0)
    r1 = eng.add_request(PREEMPT_PROMPTS[1], max_new_tokens=mnt,
                         tenant='lo', priority=0)
    while min(len(r0.tokens), len(r1.tokens)) < 2:
        eng.step()                      # both residents mid-decode
    r2 = eng.add_request(PREEMPT_PROMPTS[2], max_new_tokens=mnt,
                         tenant='hi', priority=1)
    while eng.scheduler.pending:
        eng.step()
    assert eng.scheduler.preempted == base + 1
    victim = r1 if r1._preempts else r0
    assert victim._preempts == 1 and victim.outcome == 'ok'
    assert reg.get('qos_preempted_total').labels('lo').value() == pre0 + 1
    # the caller-visible streams equal an unpreempted run's
    assert [r0.tokens, r1.tokens, r2.tokens] == ref
    for r in (r0, r1, r2):
        evs = _events_for(log, r.id)
        assert len(evs) == 1 and evs[0]['outcome'] == 'ok'


def test_preempt_budget_exhausted_is_terminal(paged_preempt):
    eng, log = paged_preempt
    eng.scheduler.max_preempts = 0
    r0 = eng.add_request(PREEMPT_PROMPTS[0], max_new_tokens=8, priority=0)
    r1 = eng.add_request(PREEMPT_PROMPTS[1], max_new_tokens=8, priority=0)
    while min(len(r0.tokens), len(r1.tokens)) < 2:
        eng.step()
    r2 = eng.add_request(PREEMPT_PROMPTS[2], max_new_tokens=8, priority=1)
    while eng.scheduler.pending:
        eng.step()
    victim = r1 if r1._preempts else r0
    survivor = r0 if victim is r1 else r1
    assert victim.done and victim.outcome == 'preempted'
    assert survivor.outcome == 'ok' and r2.outcome == 'ok'
    assert len(_events_for(log, victim.id)) == 1
    assert not eng.scheduler.resident and not eng.scheduler._nblocks


# ---- request tracing (tests/test_tracing.py's serving lifecycle) ----------


def test_request_spans_share_the_wide_event_trace_id(model):
    from paddle_tpu_torch.monitor import tracing as _tracing
    tracer = _tracing.Tracer(capacity=64)
    log = _events.RequestLog(capacity=16)
    prev_t = _tracing.set_default_tracer(tracer)
    prev_l = _events.set_default_request_log(log)
    try:
        eng = PagedContinuousBatchingEngine(
            model, num_seqs=2, max_len=32, page_size=8, prefill_chunk=8,
            decode_block=2)
        req = eng.add_request([3, 1, 4, 1, 5], max_new_tokens=3)
        eng.run()
    finally:
        _tracing.set_default_tracer(prev_t)
        _events.set_default_request_log(prev_l)
    (ev,) = [e for e in log.events() if e['request_id'] == req.id]
    tree = [s for s in tracer.spans() if s['trace_id'] == ev['trace_id']]
    root = [s for s in tree if s['parent_id'] is None]
    assert len(root) == 1 and root[0]['name'] == 'serving.request'
    assert [e['name'] for e in root[0]['events']][:2] == ['queued',
                                                          'admitted']
    assert root[0]['events'][-1]['name'] == 'retired'
    assert root[0]['tags']['tokens'] == 3
    phases = {s['name'] for s in tree if s['parent_id'] is not None}
    assert phases == {'serving.prefill', 'serving.decode'}


def test_tracer_ring_is_bounded_and_disabled_tracer_is_free():
    from paddle_tpu_torch.monitor import tracing as _tracing
    from paddle_tpu_torch.monitor.registry import MetricRegistry
    reg = MetricRegistry()
    tracer = _tracing.Tracer(capacity=2, registry=reg)
    for i in range(3):
        tracer.start_span('s%d' % i).finish()
    assert [s['name'] for s in tracer.spans()] == ['s1', 's2']
    assert reg.get('trace_spans_dropped_total').value() == 1
    with tracer.start_span('outer') as outer:
        child = tracer.start_span('inner')
    assert child.parent_id == outer.span_id
    assert child.trace_id == outer.trace_id
    tracer.disable()
    assert tracer.start_span('off') is _tracing.NULL_SPAN
    assert reg.get('trace_spans_started_total').value() == 5
