"""The port's serving slice (paddle_tpu_torch/serving/, GPTSlotCache and
GPTPagedCache in paddle_tpu_torch/text/models/gpt.py) against the JAX
package's, on the CPU.

The engines' contract is the JAX package's (tests/test_serving.py): greedy
tokens through the slot engine, and through the paged engine with prefix
sharing and with speculative decoding, are IDENTICAL to sequential
generate() for mixed-length prompts. Here they must also equal the JAX
engines' tokens for the same weights (carried across with
load_paddle_tpu_state). The cache forwards must give the JAX caches'
logits and buffers to 1e-5: both compute f32 products of the same
operands, summed in another order (~1e-7 relative here).
"""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.serving import ContinuousBatchingEngine as JSlotEngine
from paddle_tpu.serving import PagedContinuousBatchingEngine as JPagedEngine
from paddle_tpu.text.models import gpt as jgpt
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      PagedContinuousBatchingEngine)
from paddle_tpu_torch.text.models import gpt as tgpt

CFG = dict(vocab_size=211, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=128, dropout=0.0)
HEADS, HEAD_DIM = 4, 16
MNT = 9
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope='module')
def pair():
    paddle.seed(7)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**CFG))
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**CFG), device='cpu', seed=1)
    tgpt.load_paddle_tpu_state(tm, state)
    tm.eval()
    return jm, tm


@pytest.fixture(scope='module')
def prompts():
    rng = np.random.RandomState(3)
    # mixed lengths, not monotonic, so admission order and slot layout
    # differ from length order
    return [[int(t) for t in rng.randint(0, 211, n)]
            for n in (3, 17, 7, 12, 5, 21, 9, 4)]


@pytest.fixture(scope='module')
def shared_prompts():
    """Six prompts of which four share a two-page head (16 tokens)."""
    rng = np.random.RandomState(11)
    system = [int(t) for t in rng.randint(0, 211, 16)]
    out = [system + [int(t) for t in rng.randint(0, 211, 3 + i)]
           for i in range(4)]
    return out + [[int(t) for t in rng.randint(0, 211, n)] for n in (6, 19)]


def _sequential(model, prompt, mnt, **kw):
    out = model.generate(torch.tensor([prompt]), max_new_tokens=mnt, **kw)
    return [int(t) for t in out[0, len(prompt):]]


ENGINE_KW = dict(max_len=64, prefill_chunk=8, decode_block=4)


@pytest.fixture(scope='module')
def jax_tokens(pair, prompts, shared_prompts):
    """Each JAX engine run once: slot, paged with the prefix cache (on the
    shared prompts), paged with spec_k=3."""
    jm, _ = pair
    slot = JSlotEngine(jm, num_slots=3, **ENGINE_KW)
    paged = JPagedEngine(jm, num_seqs=3, page_size=8, **ENGINE_KW)
    spec = JPagedEngine(jm, num_seqs=3, page_size=8, spec_k=3, **ENGINE_KW)
    return {'slot': slot.generate(prompts, max_new_tokens=MNT),
            'paged': paged.generate(shared_prompts, max_new_tokens=MNT),
            'spec': spec.generate(prompts, max_new_tokens=MNT)}


@pytest.fixture(scope='module')
def expect(pair, prompts, shared_prompts):
    _, tm = pair
    return {'prompts': [_sequential(tm, p, MNT) for p in prompts],
            'shared': [_sequential(tm, p, MNT) for p in shared_prompts]}


# ---- the caches against the JAX model ---------------------------------


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_slot_cache_forward_matches_jax(pair):
    jm, tm = pair
    slots, max_len, n = 3, 16, 2
    lengths = np.array([0, 5, 9])
    ids = np.random.RandomState(0).randint(0, 211, (slots, n))
    bufs = [(_rand((slots, max_len, HEADS, HEAD_DIM), 2 * i),
             _rand((slots, max_len, HEADS, HEAD_DIM), 2 * i + 1))
            for i in range(CFG['num_layers'])]
    jcaches = [jgpt.GPTSlotCache(paddle.to_tensor(k), paddle.to_tensor(v),
                                 np.asarray(lengths, np.int32))
               for k, v in bufs]
    j_logits, j_new = jm(paddle.to_tensor(ids), caches=jcaches)
    tcaches = []
    for k, v in bufs:
        c = tgpt.GPTSlotCache.empty(slots, max_len, HEADS, HEAD_DIM,
                                    device='cpu')
        c.k.copy_(torch.from_numpy(k))
        c.v.copy_(torch.from_numpy(v))
        c.lengths = torch.from_numpy(lengths)
        tcaches.append(c)
    with torch.no_grad():
        t_logits, t_new = tm(torch.from_numpy(ids), caches=tcaches)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits.numpy()),
                               **TOL)
    for jc, tc in zip(j_new, t_new):
        assert tuple(tc.k.shape) == (slots, max_len, HEADS, HEAD_DIM)
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k.numpy()),
                                   **TOL)
        np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v.numpy()),
                                   **TOL)
        # lengths are the engine's to advance
        np.testing.assert_array_equal(tc.lengths.numpy(), lengths)


def test_paged_cache_forward_matches_jax(pair):
    """Two rows share page 1 (a full block below both lengths); the third
    row is frozen at length 0 with every block on the scratch page, where
    its writes land."""
    jm, tm = pair
    pages, page, n = 6, 4, 2
    bt = np.array([[1, 2, 0], [1, 3, 4], [0, 0, 0]])
    lengths = np.array([6, 7, 0])
    ids = np.random.RandomState(1).randint(0, 211, (3, n))
    pools = [(_rand((pages, page, HEADS, HEAD_DIM), 10 + 2 * i),
              _rand((pages, page, HEADS, HEAD_DIM), 11 + 2 * i))
             for i in range(CFG['num_layers'])]
    jcaches = [jgpt.GPTPagedCache(paddle.to_tensor(k), paddle.to_tensor(v),
                                  np.asarray(bt, np.int32),
                                  np.asarray(lengths, np.int32))
               for k, v in pools]
    j_logits, j_new = jm(paddle.to_tensor(ids), caches=jcaches)
    tcaches = []
    for k, v in pools:
        c = tgpt.GPTPagedCache.empty(pages, page, 3, 3, HEADS, HEAD_DIM,
                                     device='cpu')
        c.k.copy_(torch.from_numpy(k))
        c.v.copy_(torch.from_numpy(v))
        c.block_tables = torch.from_numpy(bt)
        c.lengths = torch.from_numpy(lengths)
        tcaches.append(c)
    with torch.no_grad():
        t_logits, t_new = tm(torch.from_numpy(ids), caches=tcaches)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits.numpy()),
                               **TOL)
    for jc, tc, (k0, _) in zip(j_new, t_new, pools):
        jk = np.asarray(jc.k.numpy())
        np.testing.assert_allclose(tc.k.numpy(), jk, **TOL)
        np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v.numpy()),
                                   **TOL)
        # the shared page is untouched; the frozen row wrote to scratch
        np.testing.assert_array_equal(tc.k[1].numpy(), k0[1])
        assert not np.array_equal(tc.k[0, :2].numpy(), k0[0, :2])
        np.testing.assert_array_equal(tc.k[0, 2:].numpy(), k0[0, 2:])


class _CountingIndex(tgpt.SharedIndex):
    builds = 0

    def get(self, key, build):
        def counted():
            self.builds += 1
            return build()
        return super().get(key, counted)


@pytest.mark.parametrize('kind', ['slot', 'paged'])
def test_shared_index_built_once_per_forward(pair, kind):
    """One SharedIndex handed to every layer's cache builds the write rows,
    the gather view and the mask once, and changes no logit or buffer."""
    _, tm = pair
    lengths = np.array([6, 0, 3])
    ids = torch.from_numpy(np.random.RandomState(4).randint(0, 211, (3, 2)))

    def caches(index):
        out = []
        for i in range(CFG['num_layers']):
            if kind == 'slot':
                c = tgpt.GPTSlotCache.empty(3, 12, HEADS, HEAD_DIM,
                                            device='cpu')
            else:
                c = tgpt.GPTPagedCache.empty(6, 4, 3, 3, HEADS, HEAD_DIM,
                                             device='cpu')
                c.block_tables = torch.tensor([[1, 2, 0], [3, 0, 0],
                                               [4, 5, 0]])
            c.kt.copy_(torch.from_numpy(_rand(tuple(c.kt.shape), 30 + i)))
            c.vt.copy_(torch.from_numpy(_rand(tuple(c.vt.shape), 40 + i)))
            c.lengths = torch.from_numpy(lengths)
            c.index = index
            out.append(c)
        return out

    index = _CountingIndex()
    with torch.no_grad():
        shared_logits, shared = tm(ids, caches=caches(index))
        own_logits, own = tm(ids, caches=caches(None))
    assert index.builds == 1
    torch.testing.assert_close(shared_logits, own_logits, rtol=0, atol=0)
    for a, b in zip(shared, own):
        torch.testing.assert_close(a.kt, b.kt, rtol=0, atol=0)
        torch.testing.assert_close(a.vt, b.vt, rtol=0, atol=0)


def test_paged_cache_host_lengths_overflow_raises(pair):
    _, tm = pair
    caches = [tgpt.GPTPagedCache.empty(4, 4, 2, 1, HEADS, HEAD_DIM,
                                       device='cpu')
              for _ in range(CFG['num_layers'])]
    for c in caches:
        c.lengths = np.array([7])       # a host array: checked
    with torch.no_grad(), pytest.raises(ValueError, match='overflow'):
        tm(torch.zeros((1, 2), dtype=torch.long), caches=caches)


@pytest.mark.parametrize('kind', ['slot', 'paged'])
def test_serving_caches_refuse_training(pair, kind):
    _, tm = pair
    if kind == 'slot':
        cache = tgpt.GPTSlotCache.empty(1, 8, HEADS, HEAD_DIM, device='cpu')
    else:
        cache = tgpt.GPTPagedCache.empty(3, 4, 2, 1, HEADS, HEAD_DIM,
                                         device='cpu')
    tm.train()
    try:
        with pytest.raises(RuntimeError, match='inference-only'):
            tm(torch.zeros((1, 1), dtype=torch.long),
               caches=[cache] * CFG['num_layers'])
    finally:
        tm.eval()


def test_slot_cache_reads_a_view(pair):
    """The masked read takes each slot's keys as a view of the stored
    [S, H, L, Dh] buffer: the [S, L, H, Dh] interface transposes back to
    a contiguous tensor with no copy."""
    c = tgpt.GPTSlotCache.empty(2, 8, HEADS, HEAD_DIM, device='cpu')
    assert c.kt.is_contiguous()
    back = c.k.transpose(1, 2)
    assert back.is_contiguous() and back.data_ptr() == c.kt.data_ptr()


# ---- the engines: token parity ---------------------------------------


def test_slot_engine_parity(pair, prompts, jax_tokens, expect):
    _, tm = pair
    eng = ContinuousBatchingEngine(tm, num_slots=3, **ENGINE_KW)
    got = eng.generate(prompts, max_new_tokens=MNT)
    assert got == expect['prompts']
    assert got == jax_tokens['slot']
    # every slot cycled through several occupants
    assert eng.allocator.in_use == 0 and eng.scheduler.pending == 0


def test_paged_engine_prefix_parity(pair, shared_prompts, jax_tokens,
                                    expect):
    _, tm = pair
    kw = dict(num_seqs=3, page_size=8, **ENGINE_KW)
    eng = PagedContinuousBatchingEngine(tm, **kw)
    got = eng.generate(shared_prompts, max_new_tokens=MNT)
    assert got == expect['shared']
    assert got == jax_tokens['paged']
    rep = eng.metrics.report()
    assert rep['prefix_hits'] > 0
    cold = PagedContinuousBatchingEngine(tm, prefix_cache=False, **kw)
    assert cold.generate(shared_prompts, max_new_tokens=MNT) == got
    # the hits are prefill work not done
    assert rep['prefill_tokens'] < cold.metrics.report()['prefill_tokens']
    # only prefix-cache references outlive the requests
    assert eng.pages.in_use == len(eng.prefix)


def test_paged_engine_spec_parity(pair, prompts, jax_tokens, expect):
    _, tm = pair
    eng = PagedContinuousBatchingEngine(tm, num_seqs=3, page_size=8,
                                        spec_k=3, **ENGINE_KW)
    got = eng.generate(prompts, max_new_tokens=MNT)
    assert got == expect['prompts']
    assert got == jax_tokens['spec']
    rep = eng.metrics.report()
    assert rep['spec_proposed'] > 0
    assert 0.0 <= rep['spec_accept_rate'] <= 1.0
    with pytest.raises(ValueError, match='greedy-only'):
        eng.add_request(prompts[0], max_new_tokens=4, do_sample=True)


def test_engines_at_the_position_limit(pair):
    """A verify pass near a row's end runs positions past the table for
    its garbage rows: they are clamped, not an index error."""
    _, tm = pair
    prompt = list(range(1, 100))
    want = _sequential(tm, prompt, 29)
    eng = PagedContinuousBatchingEngine(tm, num_seqs=2, max_len=128,
                                        page_size=8, prefill_chunk=8,
                                        decode_block=4, spec_k=3)
    assert eng.generate([prompt], max_new_tokens=29) == [want]
    slot = ContinuousBatchingEngine(tm, num_slots=1, max_len=128,
                                    prefill_chunk=8, decode_block=4)
    assert slot.generate([prompt], max_new_tokens=29) == [want]


def test_varied_budgets_and_immediate_finish(pair, prompts, expect):
    _, tm = pair
    budgets = [1, 3, MNT, 2]
    eng = ContinuousBatchingEngine(tm, num_slots=4, **ENGINE_KW)
    reqs = [eng.add_request(p, max_new_tokens=b)
            for p, b in zip(prompts, budgets)]
    eng.run()
    for req, b, full in zip(reqs, budgets, expect['prompts']):
        assert req.tokens == full[:b]


def test_slot_reuse_no_crosstalk(pair, prompts):
    _, tm = pair
    outs = [ContinuousBatchingEngine(tm, num_slots=s, **ENGINE_KW).generate(
        prompts, max_new_tokens=6) for s in (2, 8)]
    assert outs[0] == outs[1]


def test_stream_yields_all_tokens(pair, prompts, expect):
    _, tm = pair
    eng = ContinuousBatchingEngine(tm, num_slots=2, **ENGINE_KW)
    req = eng.add_request(prompts[1], max_new_tokens=MNT, stream=True)
    streamed = list(eng.stream(req))
    assert streamed == req.tokens == expect['prompts'][1]


def test_thread_safe_front_door(pair, prompts, expect):
    """Several threads submit and drive concurrently; every request still
    matches its sequential run."""
    _, tm = pair
    eng = ContinuousBatchingEngine(tm, num_slots=3, **ENGINE_KW)
    results = [None] * 3

    def worker(i):
        results[i] = eng.generate(prompts[2 * i:2 * i + 2],
                                  max_new_tokens=MNT)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert [tok for r in results for tok in r] == expect['prompts'][:6]


# ---- sampling, by its semantics ---------------------------------------


SAMPLE = dict(do_sample=True, temperature=0.8, top_k=5)


@pytest.mark.parametrize('make', [
    lambda m: ContinuousBatchingEngine(m, num_slots=2, **ENGINE_KW),
    lambda m: PagedContinuousBatchingEngine(m, num_seqs=2, page_size=8,
                                            **ENGINE_KW),
], ids=['slot', 'paged'])
def test_sampling_same_seed_same_tokens(pair, prompts, make):
    _, tm = pair
    a = make(tm).generate(prompts[:4], max_new_tokens=MNT, seed=42,
                          **SAMPLE)
    b = make(tm).generate(prompts[:4], max_new_tokens=MNT, seed=42,
                          **SAMPLE)
    c = make(tm).generate(prompts[:4], max_new_tokens=MNT, seed=43,
                          **SAMPLE)
    assert a == b
    assert a != c
    assert all(0 <= t < CFG['vocab_size'] for toks in a for t in toks)


def test_sampling_follows_generates_stream(pair, prompts):
    """Each request's generator is seeded from its seed, drawn once by the
    final prefill chunk and once a decode step: generate()'s stream."""
    _, tm = pair
    want = [_sequential(tm, p, MNT, seed=42, **SAMPLE) for p in prompts[:4]]
    eng = ContinuousBatchingEngine(tm, num_slots=2, **ENGINE_KW)
    assert eng.generate(prompts[:4], max_new_tokens=MNT, seed=42,
                        **SAMPLE) == want


def test_top_k_one_is_greedy(pair, prompts, expect):
    _, tm = pair
    eng = ContinuousBatchingEngine(tm, num_slots=3, **ENGINE_KW)
    got = eng.generate(prompts, max_new_tokens=MNT, do_sample=True,
                       top_k=1, temperature=1.7, seed=5)
    assert got == expect['prompts']


def test_other_slots_generators_untouched(pair, prompts):
    """A sampled request draws the same tokens alone and beside other
    sampled and greedy requests: no slot draws from another's generator,
    and a frozen slot draws nothing."""
    _, tm = pair
    alone = ContinuousBatchingEngine(tm, num_slots=4, **ENGINE_KW)
    ref = alone.generate([prompts[2]], max_new_tokens=MNT, seed=9,
                         **SAMPLE)[0]
    eng = ContinuousBatchingEngine(tm, num_slots=4, **ENGINE_KW)
    reqs = [eng.add_request(prompts[0], max_new_tokens=3, seed=1, **SAMPLE),
            eng.add_request(prompts[2], max_new_tokens=MNT, seed=9,
                            **SAMPLE),
            eng.add_request(prompts[5], max_new_tokens=MNT),
            eng.add_request(prompts[1], max_new_tokens=5, seed=9, **SAMPLE)]
    eng.run()
    assert reqs[1].tokens == ref
    assert len(reqs[0].tokens) == 3 and len(reqs[3].tokens) == 5


# ---- leave-outs ----------------------------------------------------------


def test_compile_introspection_is_not_ported(pair):
    _, tm = pair
    eng = ContinuousBatchingEngine(tm, num_slots=1, **ENGINE_KW)
    for call in (eng.compiled_sizes, eng.perf_estimate,
                 lambda: eng.trace_counts, lambda: eng.perf):
        with pytest.raises(NotImplementedError, match='not ported'):
            call()
