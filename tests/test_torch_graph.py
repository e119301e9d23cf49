"""The port's graph engine, GraphSAGE and TDM index against the JAX
package's, in one process.

GraphStore samples equal under one seed (native and Python stores), the
graph service over 2 shards gives the JAX service's degrees, features,
node lists and neighbor sets (and the two packages' clients and servers
talk to each other), a 2-layer GraphSAGE forward matches within 1e-5 with
the JAX weights carried across, the TDM samplers equal, and a journaled
graph shard recovers through the ShardSupervisor with the same store.
Graphs of a few dozen nodes.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import graph_learning as jgl
from paddle_tpu.distributed import graph_service as jgs
from paddle_tpu.distributed import index_dataset as jidx
from paddle_tpu.native import graph_store as jstore

from paddle_tpu_torch.distributed import graph_learning as tgl
from paddle_tpu_torch.distributed import graph_service as tgs
from paddle_tpu_torch.distributed import index_dataset as tidx
from paddle_tpu_torch.distributed import supervisor as tsup
from paddle_tpu_torch.monitor.registry import MetricRegistry
from paddle_tpu_torch.native import graph_store as tstore
from paddle_tpu_torch.testing import chaos
from paddle_tpu_torch.text.models.gpt import load_paddle_tpu_state


def _edges(seed=0, n=40, m=160, weighted=False):
    rng = np.random.RandomState(seed)
    src = rng.randint(0, n, m).astype(np.int64)
    dst = rng.randint(0, n, m).astype(np.int64)
    w = rng.rand(m).astype(np.float32) + 0.1 if weighted else None
    return src, dst, w


def _fill(store, tmp_path, tag):
    src, dst, w = _edges(weighted=True)
    store.add_edges(src[:80], dst[:80])
    store.add_edges(src[80:], dst[80:], w[80:])   # late first weights
    store.add_nodes([100, 101])
    path = tmp_path / ('edges_%s.txt' % tag)
    path.write_text('200 201 0.5\n201 202\n202 200 2.0\n')
    store.load_edge_file(str(path), reversed=True)
    for i in range(0, 40, 3):
        store.set_node_feat(i, np.arange(4, dtype=np.float32) + i)


def _store_reads(store, seed):
    ids = np.asarray([0, 1, 5, 7, 39, 100, 201, 999], np.int64)
    out = [store.node_count(), store.edge_count(), store.degree(ids),
           store.get_node_feat(ids, 4),
           np.sort(store.pull_graph_list(1, 0, 100))]
    if seed is not None:
        out.append(store.sample_neighbors(ids, 6))
        out.append(store.random_sample_nodes(5))
    out.append(store.remove_nodes([5, 100, 12345]))
    out.append(store.node_count())
    return out


@pytest.mark.parametrize('force_python', [False, True])
def test_graph_store_matches_jax(tmp_path, force_python):
    """Same seed, same calls: equal samples from the two packages' native
    stores (each library's generator, seeded on this thread) and from
    their Python stores (numpy's)."""
    jst = jstore.GraphStore(seed=7, force_python=force_python)
    tst = tstore.GraphStore(seed=7, force_python=force_python)
    want_type = '_PythonStore' if force_python else '_NativeStore'
    assert type(tst).__name__ == type(jst).__name__ == want_type
    _fill(jst, tmp_path, 'j')
    _fill(tst, tmp_path, 't')
    want, got = _store_reads(jst, 7), _store_reads(tst, 7)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_graph_store_isolated_and_weighted_sampling():
    st = tstore.GraphStore(seed=1)
    st.add_edges([0, 0, 0], [1, 2, 3], [0.0, 0.0, 1.0])
    assert (st.sample_neighbors([0], 50) == 3).all()     # weight 0: never
    assert (st.sample_neighbors([9], 4) == -1).all()     # isolated: pad


def _service_reads(client, n=40):
    ids = np.arange(n)
    return [client.get_degree('default', ids),
            client.get_node_feat('default', ids, 4),
            np.sort(np.concatenate([
                client.pull_graph_list('default', s, shard, 0, 1000)
                for s in range(2) for shard in range(16)]))]


def _load(client):
    src, dst, _ = _edges(1)
    client.add_edges('default', src, dst)
    client.add_edges('default', dst, src)
    rng = np.random.RandomState(2)
    client.set_node_feat('default', np.arange(40),
                         rng.randn(40, 4).astype(np.float32))
    return src, dst


def _neighbors(src, dst, node):
    return set(dst[src == node].tolist()) | set(src[dst == node].tolist())


def _check_samples(client, src, dst, fanout=8):
    ids = np.arange(40)
    out = client.random_sample_neighboors('default', ids, fanout)
    assert out.shape == (40, fanout)
    for i in ids:
        nb = _neighbors(src, dst, i)
        if nb:
            assert set(out[i].tolist()) <= nb, i
        else:
            assert (out[i] == -1).all()


def test_graph_service_two_shards_matches_jax():
    jsvc, tsvc = jgs.GraphPyService(), tgs.GraphPyService()
    jcli, tcli = jsvc.set_up(num_servers=2), tsvc.set_up(num_servers=2)
    try:
        src, dst = _load(jcli)
        _load(tcli)
        for a, b in zip(_service_reads(jcli), _service_reads(tcli)):
            np.testing.assert_array_equal(b, a)
        _check_samples(tcli, src, dst)
        assert tcli.remove_graph_node('default', [3, 4]) == \
            jcli.remove_graph_node('default', [3, 4]) == 2
        tcli.add_graph_node('default', [77])
        assert tcli.get_degree('default', [3, 77]).tolist() == [0, 0]
        assert len(tcli.random_sample_nodes('default', 0, 5)) == 5
    finally:
        jsvc.stop()
        tsvc.stop()


@pytest.mark.parametrize('server_mod,client_mod',
                         [(jgs, tgs), (tgs, jgs)],
                         ids=['port-client-jax-server',
                              'jax-client-port-server'])
def test_graph_socket_interop(server_mod, client_mod):
    servers = [server_mod.GraphPyServer(rank=i) for i in range(2)]
    for s in servers:
        s.start_server()
    ref = jgs.GraphPyService()
    rcli = ref.set_up(num_servers=2)
    cli = client_mod.GraphPyClient(['127.0.0.1:%d' % s.port
                                    for s in servers])
    try:
        src, dst = _load(cli)
        _load(rcli)
        for a, b in zip(_service_reads(rcli), _service_reads(cli)):
            np.testing.assert_array_equal(b, a)
        _check_samples(cli, src, dst)
    finally:
        cli.stop_server()
        ref.stop()
        for s in servers:
            s.stop_server()


def test_load_edge_file_and_fanout_padding(tmp_path):
    path = tmp_path / 'edges.txt'
    path.write_text('0 1\n0 2\n3 0\n')
    svc = tgs.GraphPyService()
    cli = svc.set_up(num_servers=2)
    try:
        assert cli.load_edge_file('default', str(path)) == 3
        out = tgl.neighbor_sample(cli, 'default', np.asarray([0, 5]), 3)
        assert out.shape == (2, 3)
        assert set(out[0].tolist()) <= {1, 2}
        assert (out[1] == 5).all()          # isolated: the node itself
    finally:
        svc.stop()


# ---- GraphSAGE -----------------------------------------------------------


def test_graphsage_two_layers_match_jax():
    """Two-hop batch from the service, then a 2-layer GraphSAGE (mean, the
    second without an activation) on the same features: the JAX layers'
    state_dicts carried across, outputs within 1e-5."""
    svc = tgs.GraphPyService()
    cli = svc.set_up(num_servers=2)
    try:
        _load(cli)
        self_f, (hop1, hop2) = tgl.sample_and_gather(
            cli, 'default', np.arange(6), [5, 3], 4)
        assert self_f.shape == (6, 4) and hop1.shape == (6, 5, 4) \
            and hop2.shape == (6, 5, 3, 4)
        jself, (jhop1, jhop2) = jgl.sample_and_gather(
            cli, 'default', np.arange(6), [5, 3], 4)
        assert jhop2.shape == hop2.shape
    finally:
        svc.stop()
    paddle.seed(3)
    j1, j2 = jgl.GraphSageLayer(4, 16), jgl.GraphSageLayer(16, 7, act=None)
    t1 = tgl.GraphSageLayer(4, 16, device='cpu')
    t2 = tgl.GraphSageLayer(16, 7, act=None, device='cpu')
    for j, t in ((j1, t1), (j2, t2)):
        state = {k: np.asarray(v.numpy()) for k, v in j.state_dict().items()}
        assert set(state) == {'linear.weight', 'linear.bias'}
        load_paddle_tpu_state(t, state)

    def jfwd(s, h1, h2):
        a = j1(paddle.to_tensor(s), paddle.to_tensor(h1))
        b = j1(paddle.to_tensor(h1), paddle.to_tensor(h2))
        return np.asarray(j2(a, b).numpy())

    def tfwd(s, h1, h2):
        a = t1(torch.tensor(s), torch.tensor(h1))
        b = t1(torch.tensor(h1), torch.tensor(h2))
        return t2(a, b).detach().numpy()

    want = jfwd(self_f, hop1, hop2)
    got = tfwd(self_f, hop1, hop2)
    assert got.shape == (6, 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---- TDM -----------------------------------------------------------------


def test_tree_index_matches_jax(tmp_path):
    items = [11, 5, 42, 7, 19, 3, 27]
    jt = jidx.TreeIndex.from_items(items, branch=2)
    tt = tidx.TreeIndex.from_items(items, branch=2)
    for fn, args in (('total_node_nums', ()), ('height', ()),
                     ('get_all_leafs', ()), ('get_nodes', ([0, 1, 5, 99],)),
                     ('get_layer_codes', (2,)), ('get_travel_codes', (42,)),
                     ('get_ancestor_codes', (items, 1)),
                     ('get_children_codes', (1,)),
                     ('get_pi_relation', (items, 2)),
                     ('get_travel_path', (9, 0))):
        assert getattr(tt, fn)(*args) == getattr(jt, fn)(*args), fn
    path = str(tmp_path / 'tree')
    tt.save(path)
    wrap = tidx.IndexWrapper()
    wrap.insert_tree_index('t', path + '.npz')
    loaded = wrap.get_tree_index('t')
    assert loaded.get_all_leafs() == jt.get_all_leafs()
    wrap.clear_tree()
    with pytest.raises(KeyError):
        wrap.get_tree_index('t')


def test_tdm_samplers_match_jax():
    items = list(range(100, 116))
    jt = jidx.TreeIndex.from_items(items, branch=2)
    tt = tidx.TreeIndex.from_items(items, branch=2)
    users = [[1, 2], [3, 4], [5, 6]]
    targets = [103, 110, 115]
    for counts in (None, [1, 2, 3]):
        want = jidx.LayerWiseSampler(jt, counts, seed=4).sample(users,
                                                                targets)
        got = tidx.LayerWiseSampler(tt, counts, seed=4).sample(users,
                                                               targets)
        assert got == want and len(got) > len(targets)

    def score(user, nid):
        return -abs(nid - 109)

    assert tidx.BeamSearchSampler(tt, 2).sample(None, score) == \
        jidx.BeamSearchSampler(jt, 2).sample(None, score)
    assert set(tidx.BeamSearchSampler(tt, 2).sample(None, score)) <= \
        set(items)


# ---- graph shard recovery ------------------------------------------------


def _seeded_samples(store, ids):
    """Samples drawn on this thread from the store's library after seeding
    its generator here (the service's handler threads draw unseeded)."""
    store._lib.gs_seed(13)
    return store.sample_neighbors(ids, 7)


def test_graph_shard_recovers_the_same_store(tmp_path):
    reg = MetricRegistry()
    holder = {'srv': tgs.GraphPyServer(rank=0)}
    holder['srv'].start_server()
    port = holder['srv'].port

    def restart():
        holder['srv'] = tgs.GraphPyServer(rank=0, port=port)
        holder['srv'].start_server()

    journal = tsup.PushJournal('loader', registry=reg)
    cli = tgs.GraphPyClient(['127.0.0.1:%d' % port], journal=journal)
    try:
        src, dst, _ = _edges(3)
        cli.add_edges('default', src[:100], dst[:100])
        cli.set_node_feat('default', np.arange(10),
                          np.ones((10, 4), np.float32))
        sv = tsup.ShardSupervisor(miss_threshold=1, restart_budget=3,
                                  ping_timeout=0.5, registry=reg)
        sv.add_shard(tsup.ShardSpec('graph0', '127.0.0.1:%d' % port,
                                    role='graph', restart=restart,
                                    snapshot_dir=str(tmp_path),
                                    clients=(cli,)))
        sv.snapshot_all()
        cli.add_edges('default', src[100:], dst[100:])   # replayed later
        ids = np.arange(40)
        degrees = cli.get_degree('default', ids)
        feats = cli.get_node_feat('default', ids, 4)
        before = _seeded_samples(holder['srv']._srv.stores['default'], ids)
        chaos.kill_server(holder['srv'])
        assert sv.poll() == {'graph0': True}
        np.testing.assert_array_equal(cli.get_degree('default', ids),
                                      degrees)
        np.testing.assert_array_equal(cli.get_node_feat('default', ids, 4),
                                      feats)
        after = _seeded_samples(holder['srv']._srv.stores['default'], ids)
        np.testing.assert_array_equal(after, before)
        assert (journal.replayed, journal.dedup_hits) == (1, 0)
        assert cli.replay_journal() == (1, 1)      # a second replay dedups
        np.testing.assert_array_equal(cli.get_degree('default', ids),
                                      degrees)
    finally:
        cli.close()
        holder['srv'].stop_server()


def test_training_supervisor_snapshots_shards(tmp_path):
    """TrainingSupervisor(shard_supervisor=...) takes a snapshot barrier of
    the shards at every periodic checkpoint and trims their journals."""
    import paddle_tpu_torch as tpt
    srv = tgs.GraphPyServer(rank=0)
    srv.start_server()
    journal = tsup.PushJournal('loader', registry=MetricRegistry())
    cli = tgs.GraphPyClient(['127.0.0.1:%d' % srv.port], journal=journal)
    try:
        sv = tsup.ShardSupervisor(registry=MetricRegistry())
        sv.add_shard(tsup.ShardSpec('graph0', '127.0.0.1:%d' % srv.port,
                                    role='graph',
                                    snapshot_dir=str(tmp_path / 'snaps'),
                                    clients=(cli,)))
        sup = tsup.TrainingSupervisor(str(tmp_path / 'ckpt'),
                                      save_every_steps=2,
                                      shard_supervisor=sv,
                                      registry=MetricRegistry())
        assert sup.shards is sv
        net = tpt.nn.Linear(2, 1, device='cpu')
        model = tpt.Model(net)
        model.prepare(optimizer=tpt.optimizer.SGD(
            learning_rate=0.1, parameters=net.parameters()),
            loss=lambda o, y: ((o - y) ** 2).mean())
        cli.add_edges('default', [1, 2], [2, 3])
        assert len(journal) == 1
        sup.on_step(model, 0, 1, 1)            # not a checkpoint step
        assert len(journal) == 1
        sup.on_step(model, 0, 2, 2)            # periodic: barrier
        assert len(journal) == 0
        assert any(n.startswith('graph0_snap_')
                   for n in os.listdir(tmp_path / 'snaps'))
    finally:
        cli.close()
        srv.stop_server()
