"""Ring attention and Ulysses of the port (paddle_tpu_torch/ops/
ring_attention.py, distributed/sp.py): the plain ring, the ring on the
flash ops (their plain versions on the CPU), the zigzag ring and Ulysses
in a gloo world of 2 CPU ranks against the JAX package's *_sharded entries
and sp_attention on 2 of its virtual devices, forward and gradients,
causal and not, within atol 2e-4 (tests/test_distributed.py's bound); and
the ring's block steps, simulated over every block of a P-block ring in
one process as the card's check runs them, against plain attention.
The rank bodies are in torch_dist_bodies.py (nothing there imports jax).
"""
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from paddle_tpu.distributed import sp as jsp
from paddle_tpu.ops import ring_attention as jra

import torch_dist_bodies as bodies

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import ring_attention as ra

B, N, H, D = 2, 32, 4, 16
CASES = [('ring_attention', False), ('ring_attention', True),
         ('ring_flash_attention', False), ('ring_flash_attention', True),
         ('ulysses_attention', False), ('ulysses_attention', True),
         ('zigzag', True)]


def _data():
    rng = np.random.RandomState(11)
    return {name: rng.standard_normal((B, N, H, D)).astype(np.float32)
            for name in ('q', 'k', 'v', 'cot')}


@pytest.fixture(scope='module')
def world2(tmp_path_factory):
    root = bodies.shared_root(tmp_path_factory)
    job = {'sections': [('attention', {'kind': 'attention',
                                       'data': _data(),
                                       'cases': CASES})]}
    return bodies.world_results(root, 'ring2', 2, job)


def _jax_side(name, causal, data):
    mesh = Mesh(np.asarray(jax.devices()[:2]), ('sp',))
    q, k, v = (jnp.asarray(data[n]) for n in ('q', 'k', 'v'))
    cot = jnp.asarray(data['cot'])
    if name == 'zigzag':
        state = jsp.make_sp_state(mesh, 'sp', 'zigzag')

        def fn(q, k, v):
            return jsp.sp_attention(q, k, v, causal=True,
                                    scale=1.0 / math.sqrt(D), state=state)
    else:
        fn = functools.partial(getattr(jra, name + '_sharded'), mesh=mesh,
                               causal=causal)
    @jax.jit
    def run(q, k, v, cot):
        out, vjp = jax.vjp(fn, q, k, v)
        return (out,) + vjp(cot)
    return [np.asarray(t) for t in run(q, k, v, cot)]


@pytest.mark.parametrize('name,causal', CASES)
def test_sequence_parallel_attention_matches_jax(world2, name, causal):
    got = bodies.section(world2, 'attention')
    want = _jax_side(name, causal, _data())
    key = '%s_%s' % (name, causal)
    for rank in range(2):
        res = got[rank][key]
        for label, g, w in zip(('out', 'dq', 'dk', 'dv'),
                               (res['out'], res['dq'], res['dk'],
                                res['dv']), want):
            np.testing.assert_allclose(g, w, atol=2e-4, err_msg='%s %s '
                                       'rank %d' % (key, label, rank))


def _plain(q, k, v, do, causal, scale):
    """Plain full attention in f64 on [b, h, n, d]: (o, lse, dq, dk, dv)."""
    q, k, v = (t.double().requires_grad_() for t in (q, k, v))
    s = q @ k.transpose(-1, -2) * scale
    if causal:
        n = s.shape[-1]
        s = s.masked_fill(~torch.ones(n, n, dtype=torch.bool).tril(), -1e30)
    lse = torch.logsumexp(s, -1, keepdim=True)
    o = torch.exp(s - lse) @ v
    o.backward(do.double())
    return o.detach(), lse.detach(), q.grad, k.grad, v.grad


@pytest.mark.parametrize('n,parts,causal,routes', [
    (64, 2, True, ('flash', 'bwd_fused')),
    (64, 2, False, ('flash', 'bwd_fused')),
    (192, 4, True, ('flash', 'bwd_two_pass')),
    (128, 2, False, ('fwd_long', 'bwd_long'))])
def test_ring_block_steps_match_plain_attention(monkeypatch, n, parts,
                                                causal, routes):
    """The block steps over every block of a P-block ring, as the card's
    check runs them (routing thresholds cut so that blocks of 32 take the
    fused backward, 48 the two-pass pair and 64 the long route)."""
    monkeypatch.setattr(fa, 'LONG_SEQ', 64)
    monkeypatch.setattr(fa, 'FUSED_BWD_MAX_SEQ', 32)
    gen = torch.Generator().manual_seed(n + parts)
    q, k, v, do = (torch.randn(1, 2, n, 64, generator=gen)
                   for _ in range(4))
    c, scale = n // parts, 1.0 / 8.0
    for key in fa.counts:
        monkeypatch.setitem(fa.counts, key, 0)

    def blk(t, i):
        return t[:, :, i * c:(i + 1) * c]

    def seen(r):
        return [s for s in range(parts) if s != r and (not causal or s < r)]
    outs, lses = [], []
    for r in range(parts):
        o, lse = ra.ring_flash_fwd_block(blk(q, r), blk(k, r), blk(v, r),
                                         None, None, causal, scale)
        for s in seen(r):
            o, lse = ra.ring_flash_fwd_block(blk(q, r), blk(k, s), blk(v, s),
                                             o, lse, False, scale)
        outs.append(o)
        lses.append(lse)
    dqs, dks, dvs = [], [None] * parts, [None] * parts
    for r in range(parts):
        dq, dks[r], dvs[r] = ra.ring_flash_bwd_block(
            blk(q, r), blk(k, r), blk(v, r), outs[r], lses[r], blk(do, r),
            causal, scale, None, dks[r], dvs[r])
        for s in seen(r):
            dq, dks[s], dvs[s] = ra.ring_flash_bwd_block(
                blk(q, r), blk(k, s), blk(v, s), outs[r], lses[r],
                blk(do, r), False, scale, dq, dks[s], dvs[s])
        dqs.append(dq)
    o_ref, lse_ref, dq_ref, dk_ref, dv_ref = _plain(q, k, v, do, causal,
                                                    scale)
    np.testing.assert_allclose(torch.cat(outs, 2).numpy(), o_ref.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(torch.cat(lses, 2).numpy(), lse_ref.numpy(),
                               atol=1e-5)
    for got, want in ((dqs, dq_ref), (dks, dk_ref), (dvs, dv_ref)):
        np.testing.assert_allclose(torch.cat(got, 1).transpose(1, 2).numpy(),
                                   want.numpy(), atol=1e-4)
    blocks = sum(1 + len(seen(r)) for r in range(parts))
    assert {key: fa.counts[key] for key in routes} == \
        {key: blocks for key in routes}


def test_ring_on_one_rank_is_attention_with_dropout_semantics():
    """Without a process group the rings are one block: ordinary attention;
    the plain ring's dropout keeps about 1 - p of the weights, scales them
    by 1 / (1 - p) and is the identity at p = 0."""
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 64, 2, 16, generator=gen) for _ in range(3))
    want = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True).transpose(1, 2)
    for fn in (ra.ring_attention, ra.ring_flash_attention,
               ra.ulysses_attention):
        np.testing.assert_allclose(fn(q, k, v, axis_name=None,
                                      causal=True).numpy(), want.numpy(),
                                   atol=1e-5)
    ones = torch.ones(1, 256, 1, 16)
    vals = torch.randn(1, 256, 1, 16, generator=gen)
    dropped = ra.ring_attention(ones, ones, vals, axis_name=None,
                                dropout_p=0.25,
                                generator=torch.Generator().manual_seed(0))
    full = ra.ring_attention(ones, ones, vals, axis_name=None)
    # uniform weights: the output is the kept values' sum / (0.75 n)
    assert not torch.allclose(dropped, full)
    np.testing.assert_allclose(dropped.mean().item(), full.mean().item(),
                               atol=0.1)
    np.testing.assert_allclose(
        ra.ring_attention(ones, ones, vals, axis_name=None, dropout_p=0.0,
                          generator=torch.Generator()).numpy(),
        full.numpy())
