"""The port's parameter server against the JAX package's, in one process.

The same seeded inputs go through both packages: the MultiSlot parser
(native and Python), the native table and every table class over one
pull / push / push_delta / save / load sequence (bitwise rows), the four
communicators' merged pushes, socket interop both ways, the Downpour
trainer's losses (one thread, within 1e-5), the heter embeddings' pushed
rows and dense gradients (within 1e-6), the fleet's PS surface, and the
journaled shard recovery through PushJournal / ShardSupervisor (bitwise).
Sizes are a few dozen ids of dim 4-8.
"""
import os
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.distributed.ps import communicator as jcomm
from paddle_tpu.distributed.ps import dataset as jdataset
from paddle_tpu.distributed.ps import embedding_service as jes
from paddle_tpu.distributed.ps import heter as jheter
from paddle_tpu.distributed.ps import tables as jtables
from paddle_tpu.distributed.ps import trainer as jtrainer
from paddle_tpu.distributed import supervisor as jsup
from paddle_tpu.native import datafeed as jdatafeed
from paddle_tpu.native import embedding_table as jnative

import paddle_tpu_torch as tpt
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed import supervisor as tsup
from paddle_tpu_torch.distributed.ps import communicator as tcomm
from paddle_tpu_torch.distributed.ps import dataset as tdataset
from paddle_tpu_torch.distributed.ps import embedding_service as tes
from paddle_tpu_torch.distributed.ps import heter as theter
from paddle_tpu_torch.distributed.ps import runtime as truntime
from paddle_tpu_torch.distributed.ps import tables as ttables
from paddle_tpu_torch.distributed.ps import trainer as ttrainer
from paddle_tpu_torch.monitor.registry import MetricRegistry
from paddle_tpu_torch.native import datafeed as tdatafeed
from paddle_tpu_torch.native import embedding_table as tnative
from paddle_tpu_torch.nn.layer.common import Linear
from paddle_tpu_torch.testing import chaos
from paddle_tpu_torch.text.models.gpt import load_paddle_tpu_state


def _ctr_text(seed=0, lines=64, bad_every=0):
    """MultiSlot CTR lines: two sparse slots (slot1 may be empty) and a
    float label; y = 1 iff slot0 holds an id < 32."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(lines):
        n0 = rng.randint(1, 4)
        pos = rng.rand() < 0.5
        lo, hi = (0, 32) if pos else (32, 128)
        s0 = rng.randint(lo, hi, n0)
        n1 = rng.randint(0, 3)
        s1 = rng.randint(0, 64, n1)
        line = '%d %s %d %s 1 %.1f' % (n0, ' '.join(map(str, s0)), n1,
                                       ' '.join(map(str, s1)),
                                       1.0 if pos else 0.0)
        if bad_every and i % bad_every == bad_every - 1:
            line = line.split(' 1 ')[0]          # truncated: dropped
        out.append(line)
    return '\n'.join(out) + '\n'


def _write_files(tmp_path, n_files=2, lines=64):
    files = []
    for i in range(n_files):
        p = tmp_path / ('part-%d' % i)
        p.write_text(_ctr_text(seed=i, lines=lines))
        files.append(str(p))
    return files


# ---- the MultiSlot parser ------------------------------------------------


@pytest.mark.parametrize('force_python', [False, True])
def test_parse_multislot_matches_jax(force_python):
    text = _ctr_text(seed=3, lines=40, bad_every=7)
    types = ['int', 'int', 'float']
    want, n_want = jdatafeed.parse_multislot(text, types, force_python)
    got, n_got = tdatafeed.parse_multislot(text, types, force_python)
    assert n_got == n_want == 35
    for (wv, wo), (gv, go) in zip(want, got):
        assert gv.dtype == wv.dtype
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(go, wo)
    # the port's native parser and its Python one agree
    other, _ = tdatafeed.parse_multislot(text, types, not force_python)
    for (a, ao), (b, bo) in zip(got, other):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ao, bo)


def test_native_libraries_load_from_the_port():
    from paddle_tpu_torch import native
    for name in ('datafeed', 'embedding_table', 'graph_store'):
        assert native.available(name), name
        lib = native.load_library(name)
        assert os.sep + os.path.join('paddle_tpu_torch', '_build',
                                     'native') in lib._name, lib._name


def test_data_generator_text_matches_jax(tmp_path):
    """fleet's MultiSlot writers render the JAX package's text, which the
    port's dataset parses back."""
    from paddle_tpu.distributed.fleet import data_generator as jgen
    from paddle_tpu_torch.distributed.fleet import data_generator as tgen

    def make(mod, cls):
        class Gen(getattr(mod, cls)):
            def generate_sample(self, line):
                def g():
                    a, b, label = line
                    yield [('slot0', a), ('slot1', b), ('label', [label])]
                return g
        return Gen()

    samples = [([1, 2], [7], 1.0), ([3], [8, 9], 0.0), ([4], [5], 1.0)]
    strings = [([str(v) for v in a], [str(v) for v in b], str(y))
               for a, b, y in samples]
    for cls, rows in (('MultiSlotDataGenerator', samples),
                      ('MultiSlotStringDataGenerator', strings)):
        text = make(tgen, cls).run_from_memory(rows)
        assert text == make(jgen, cls).run_from_memory(rows)
    path = tmp_path / 'gen.txt'
    path.write_text(make(tgen, 'MultiSlotDataGenerator')
                    .run_from_memory(samples))
    ds = tdataset.MultiSlotDataset()
    ds.set_use_var([('slot0', 'int64'), ('slot1', 'int64'),
                    ('label', 'float32')])
    ds.set_filelist([str(path)])
    ds.set_batch_size(3)
    ds.load_into_memory()
    batch = ds.start_channel().get()
    np.testing.assert_array_equal(batch['slot0'][0], [1, 2, 3, 4])
    np.testing.assert_array_equal(batch['slot0'][1], [0, 2, 3, 4])
    np.testing.assert_array_equal(batch['label'], [1.0, 0.0, 1.0])


# ---- tables --------------------------------------------------------------


def _table_sequence(table, tmp_path, fresh, tag, push_after_load=True):
    """One pull / push / push_delta / save / load sequence; returns every
    array it read. The Python EmbeddingTable's load keeps no optimizer
    slots in either package, so a slotted optimizer cannot push to a
    loaded row there (push_after_load=False)."""
    rng = np.random.RandomState(11)
    reads = []
    ids = [3, 17, 3, 40, 9]
    reads.append(table.pull(ids))
    table.push(ids, rng.randn(5, table.dim).astype(np.float32))
    reads.append(table.pull([17, 3, 99]))
    table.push_delta([3, 99, 1234], rng.randn(3, table.dim)
                     .astype(np.float32))
    table.push([99, 40], rng.randn(2, table.dim).astype(np.float32))
    reads.append(table.pull([3, 17, 40, 9, 99]))
    path = str(tmp_path / tag)
    table.save(path)
    other = fresh()
    other.load(path)
    reads.append(other.pull([3, 17, 40, 9, 99]))
    if push_after_load:
        other.push([9, 3], rng.randn(2, table.dim).astype(np.float32))
    reads.append(other.pull([9, 3, 40]))
    return reads


def _assert_reads_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize('optimizer', ['sgd', 'adagrad'])
def test_native_table_bitwise(tmp_path, optimizer):
    kw = dict(optimizer=optimizer, lr=0.3, init_scale=0.1, seed=5)

    def jfresh():
        return jnative.NativeEmbeddingTable(6, **kw)

    def tfresh():
        return tnative.NativeEmbeddingTable(6, **kw)

    want = _table_sequence(jfresh(), tmp_path, jfresh, 'j')
    got = _table_sequence(tfresh(), tmp_path, tfresh, 't')
    _assert_reads_equal(want, got)


SPARSE_TABLES = [
    ('EmbeddingTable', dict(optimizer='sgd')),
    ('EmbeddingTable', dict(optimizer='adagrad')),
    ('EmbeddingTable', dict(optimizer='adam')),
    ('EmbeddingTable', dict(optimizer='sgd', initializer='zeros')),
    ('GeoSparseTable', dict(optimizer='adagrad')),
    ('SsdSparseTable', dict(optimizer='adagrad', max_mem_rows=2)),
    ('SsdSparseTable', dict(optimizer='adam', max_mem_rows=3)),
]


@pytest.mark.parametrize('cls,kw', SPARSE_TABLES,
                         ids=['%s-%s' % (c, '-'.join(map(str, k.values())))
                              for c, k in SPARSE_TABLES])
def test_sparse_table_bitwise(tmp_path, cls, kw):
    def mod_cls(mod):
        return getattr(mod, cls) if hasattr(mod, cls) else \
            getattr(jes if mod is jtables else tes, cls)

    kw = dict(kw, lr=0.2, init_scale=0.1, seed=4)

    def jfresh():
        return mod_cls(jtables)(5, **kw)

    def tfresh():
        return mod_cls(ttables)(5, **kw)

    jt, tt = jfresh(), tfresh()
    again = cls == 'SsdSparseTable' or kw['optimizer'] == 'sgd'
    want = _table_sequence(jt, tmp_path, jfresh, 'j', again)
    got = _table_sequence(tt, tmp_path, tfresh, 't', again)
    _assert_reads_equal(want, got)
    assert len(tt) == len(jt)


def test_entry_admission_bitwise():
    for entry in ('count', 'prob'):
        tabs = []
        for mod in (jes, tes):
            e = mod.CountFilterEntry(2) if entry == 'count' else \
                mod.ProbabilityEntry(0.5)
            tabs.append(mod.EmbeddingTable(4, seed=2, entry=e))
        for ids in ([1, 2, 1], [2, 3, 4, 1], [5, 5, 6]):
            np.testing.assert_array_equal(tabs[0].pull(ids),
                                          tabs[1].pull(ids))
        assert len(tabs[0]) == len(tabs[1])


def test_dense_tensor_and_barrier_tables(tmp_path):
    rng = np.random.RandomState(0)
    grads = [rng.randn(3, 4).astype(np.float32) for _ in range(3)]
    outs = []
    for mod, tag in ((jtables, 'j'), (ttables, 't')):
        d = mod.DenseTable((3, 4), optimizer='adam', lr=0.1, init='uniform',
                           seed=3)
        for g in grads:
            d.push(g)
        d.save(str(tmp_path / tag / 'dense'))
        d2 = mod.DenseTable((3, 4), optimizer='adam', lr=0.1)
        d2.load(str(tmp_path / tag / 'dense'))
        d2.push(grads[0])
        tt = mod.TensorTable()
        tt.set('a', [1.0, 2.0])
        tt.increment('a', [0.5, 0.5])
        outs.append((d.pull(), d2.pull(), tt.get('a'),
                     tt.increment('b', 3.0)))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)

    bt = ttables.BarrierTable(3)
    done = []
    threads = [threading.Thread(target=lambda: done.append(bt.barrier()))
               for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(5)
    assert done == [True] * 3
    with pytest.raises(TimeoutError):
        bt.barrier(timeout=0.05)


# ---- communicators -------------------------------------------------------


class _Recorder:
    """A client that records what reaches it."""

    def __init__(self):
        self.pushes = []
        self.deltas = []
        self._lock = threading.Lock()

    def push(self, table_id, ids, grads):
        with self._lock:
            self.pushes.append((table_id, np.asarray(ids).copy(),
                                np.asarray(grads).copy()))

    def push_delta(self, table_id, ids, deltas):
        with self._lock:
            self.deltas.append((table_id, np.asarray(ids).copy(),
                                np.asarray(deltas).copy()))


def _drive(mod, mode):
    rec = _Recorder()
    comm = mod.Communicator(rec, mode=mode, merge_size=3,
                            geo_need_push_nums=7)
    comm.start()
    rng = np.random.RandomState(1)
    for step in range(6):
        ids = rng.randint(0, 12, 5)
        vals = rng.randn(5, 4).astype(np.float32)
        if mode == 'geo':
            comm.push_sparse_param(step % 2, ids, vals)
        else:
            comm.push_sparse_grad(step % 2, ids, vals)
    comm.stop()
    return rec


def _totals(records):
    out = {}
    for table_id, ids, vals in records:
        for i, v in zip(ids, vals):
            key = (table_id, int(i))
            out[key] = out.get(key, 0) + v.astype(np.float64)
    return out


@pytest.mark.parametrize('mode', ['async', 'half_async', 'sync', 'geo'])
def test_communicator_merged_pushes_match_jax(mode):
    want = _drive(jcomm, mode)
    got = _drive(tcomm, mode)
    if mode in ('sync', 'geo'):
        # sent inline: the same merged sends, in the same order
        for (wt, wi, wv), (gt, gi, gv) in zip(want.pushes + want.deltas,
                                              got.pushes + got.deltas):
            assert wt == gt
            np.testing.assert_array_equal(wi, gi)
            np.testing.assert_array_equal(wv, gv)
        assert len(want.pushes + want.deltas) == \
            len(got.pushes + got.deltas) > 0
    else:
        # the send thread merges what it finds queued: compare the sums
        wt, gt = _totals(want.pushes), _totals(got.pushes)
        assert set(wt) == set(gt)
        for key in wt:
            np.testing.assert_allclose(gt[key], wt[key], rtol=0,
                                       atol=1e-5)
        for _, ids, _ in got.pushes:
            assert len(ids) == len(np.unique(ids))   # merged by id


def test_communicator_misuse_raises():
    with pytest.raises(RuntimeError, match='geo'):
        tcomm.GeoCommunicator(_Recorder()).push_sparse_grad(0, [1],
                                                            np.ones((1, 2)))
    with pytest.raises(RuntimeError, match='geo-mode only'):
        tcomm.SyncCommunicator(_Recorder()).push_sparse_param(
            0, [1], np.ones((1, 2)))


# ---- sockets -------------------------------------------------------------


def _socket_round(server_mod, client_mod, backend):
    servers = []
    for _ in range(2):
        s = server_mod.EmbeddingServer()
        s.create_table(0, dim=4, optimizer='adagrad', lr=0.2, seed=3,
                       backend=backend)
        s.create_dense_table(1, (2, 3), optimizer='sgd', lr=0.5)
        s.create_tensor_table(2)
        s.start()
        servers.append(s)
    cli = client_mod.EmbeddingClient(
        endpoints=['127.0.0.1:%d' % s.port for s in servers])
    try:
        rng = np.random.RandomState(6)
        ids = [5, 2, 9, 2, 14, 7]
        out = [cli.pull(0, ids)]
        cli.push(0, ids, rng.randn(6, 4).astype(np.float32))
        cli.push_delta(0, [5, 14], rng.randn(2, 4).astype(np.float32))
        out.append(cli.pull(0, [2, 5, 7, 9, 14]))
        cli.push_dense(1, np.ones((2, 3), np.float32))
        out.append(cli.pull_dense(1))
        cli.tensor(2, 'set', 'n', 1.0)
        out.append(cli.tensor(2, 'increment', 'n', 2.0))
        return out
    finally:
        for s in servers:
            s.stop()


@pytest.mark.parametrize('backend', [None, 'native'])
def test_socket_interop_both_ways(backend):
    want = _socket_round(jes, jes, backend)
    for server_mod, client_mod in ((tes, tes), (jes, tes), (tes, jes)):
        _assert_reads_equal(want, _socket_round(server_mod, client_mod,
                                                backend))


# ---- the Downpour trainer ------------------------------------------------


def _downpour(es, comm_mod, ds_mod, tr_mod, files, mode, **kw):
    srv = es.EmbeddingServer()
    for t in (0, 1):
        srv.create_table(t, dim=8, optimizer='adagrad', lr=0.5,
                         init_scale=0.1)
    cli = es.EmbeddingClient(servers=[srv])
    comm = comm_mod.Communicator(cli, mode=mode)
    comm.start()
    ds = ds_mod.MultiSlotDataset()
    ds.set_use_var([('slot0', 'int64'), ('slot1', 'int64'),
                    ('label', 'float32')])
    ds.set_filelist(files)
    ds.set_batch_size(16)
    ds.load_into_memory()
    ds.local_shuffle(seed=1)
    tr = tr_mod.DownpourTrainer(cli, comm, slots=['slot0', 'slot1'],
                                tables={'slot0': 0, 'slot1': 1}, emb_dim=8,
                                hidden=16, lr=0.3, n_threads=1, **kw)
    try:
        losses = tr.train_from_dataset(ds, epochs=2)
    finally:
        comm.stop()
    return np.asarray(losses), cli.pull(0, np.arange(128)), tr


@pytest.mark.parametrize('mode', ['sync', 'geo'])
def test_downpour_losses_match_jax(tmp_path, mode):
    files = _write_files(tmp_path)
    want, wrows, _ = _downpour(jes, jcomm, jdataset, jtrainer, files, mode)
    got, grows, tr = _downpour(tes, tcomm, tdataset, ttrainer, files, mode,
                               device='cpu')
    assert len(got) == len(want) == 16
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(grows, wrows, rtol=0, atol=1e-5)
    if mode == 'sync':     # geo pushes deltas every 100 rows: slower
        assert got[-4:].mean() < got[:4].mean()
    assert all(v.device.type == 'cpu' for v in tr.dense.values())


def test_downpour_two_threads_async_trains(tmp_path):
    files = _write_files(tmp_path, n_files=4)
    losses, _, _ = _downpour(tes, tcomm, tdataset, ttrainer, files,
                             'async', device='cpu')
    assert len(losses) == 32
    assert losses[-8:].mean() < losses[:8].mean()


def test_async_executor_facade(tmp_path):
    files = _write_files(tmp_path)
    srv = tes.EmbeddingServer()
    for t in (0, 1):
        srv.create_table(t, dim=8, optimizer='adagrad', lr=0.5)
    cli = tes.EmbeddingClient(servers=[srv])
    tr = ttrainer.DownpourTrainer(
        cli, tcomm.SyncCommunicator(cli), slots=['slot0', 'slot1'],
        tables={'slot0': 0, 'slot1': 1}, emb_dim=8, hidden=16, lr=0.3,
        n_threads=1, device='cpu')
    losses = ttrainer.AsyncExecutor().run_from_files(
        tr, files, slots=[('slot0', 'int64'), ('slot1', 'int64'),
                          ('label', 'float32')],
        batch_size=16, epochs=2, shuffle_seed=0)
    assert len(losses) == 16


def test_box_ps_dataset_channel(tmp_path):
    files = _write_files(tmp_path, n_files=1, lines=10)
    batches = []
    for mod in (jdataset, tdataset):
        ds = mod.BoxPSDataset()
        ds.set_use_var([('slot0', 'int64'), ('slot1', 'int64'),
                        ('label', 'float32')])
        ds.set_filelist(files)
        ds.set_batch_size(4)
        assert ds.begin_pass()
        ds.preload_into_memory()
        ch = ds.start_channel()
        got = []
        while True:
            b = ch.get()
            if b is None:
                break
            got.append(b)
        assert ds.end_pass()
        batches.append(got)
    assert len(batches[0]) == len(batches[1]) == 3
    for wb, gb in zip(*batches):
        assert wb['__size__'] == gb['__size__']
        for name in ('slot0', 'slot1'):
            np.testing.assert_array_equal(wb[name][0], gb[name][0])
            np.testing.assert_array_equal(wb[name][1], gb[name][1])
        np.testing.assert_array_equal(wb['label'], gb['label'])


# ---- the heter embeddings ------------------------------------------------


class _RecClient:
    """Wraps an in-process client; records pushes and deltas."""

    def __init__(self, cli):
        self.cli = cli
        self.pushes = []
        self.deltas = []

    def pull(self, table_id, ids):
        return self.cli.pull(table_id, ids)

    def push(self, table_id, ids, grads):
        self.pushes.append((np.asarray(ids).copy(), np.asarray(grads).copy()))
        self.cli.push(table_id, ids, grads)

    def push_delta(self, table_id, ids, deltas):
        self.deltas.append((np.asarray(ids).copy(),
                            np.asarray(deltas).copy()))
        self.cli.push_delta(table_id, ids, deltas)


def _rec_cluster(mod, dim=8):
    srv = mod.EmbeddingServer()
    srv.create_table(0, dim=dim, optimizer='sgd', lr=0.3, init_scale=0.1)
    return _RecClient(mod.EmbeddingClient(servers=[srv]))


def _heter_batch(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 64, (16, 3)).astype(np.int64)
    y = (ids.min(axis=1, keepdims=True) < 24).astype(np.float32)
    return ids, y


class _JHeterNet(jnn.Layer):
    def __init__(self, emb):
        super().__init__()
        self.emb = emb
        self.fc = jnn.Linear(24, 1)

    def forward(self, ids):
        e = self.emb(ids)
        return self.fc(e.reshape([e.shape[0], 24]))


class _THeterNet(torch.nn.Module):
    def __init__(self, emb):
        super().__init__()
        self.emb = emb
        self.fc = Linear(24, 1, device='cpu')

    def forward(self, ids):
        e = self.emb(ids)
        return self.fc(e.reshape(e.shape[0], 24))


def _state(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def test_heter_embedding_pushes_and_grads_match_jax():
    ids, y = _heter_batch()
    paddle.seed(0)
    jc = _rec_cluster(jes)
    jnet = _JHeterNet(jheter.HeterEmbedding(jc, 0, 8))
    tc = _rec_cluster(tes)
    tnet = _THeterNet(theter.HeterEmbedding(tc, 0, 8, device='cpu'))
    load_paddle_tpu_state(tnet, _state(jnet))   # push_token included
    for _ in range(2):
        jloss = JF.binary_cross_entropy_with_logits(
            jnet(paddle.to_tensor(ids.astype(np.int32))),
            paddle.to_tensor(y))
        jloss.backward()
        tloss = torch.nn.functional.binary_cross_entropy_with_logits(
            tnet(torch.tensor(ids)), torch.tensor(y))
        tloss.backward()
        np.testing.assert_allclose(tloss.item(), float(jloss.numpy()),
                                   rtol=0, atol=1e-6)
    assert len(jc.pushes) == len(tc.pushes) == 2
    for (wi, wg), (gi, gg) in zip(jc.pushes, tc.pushes):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gg, wg, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tnet.fc.weight.grad.numpy(),
                               jnet.fc.weight.grad.numpy(), rtol=0,
                               atol=1e-6)
    assert float(tnet.emb.push_token.grad.abs().sum()) == 0.0


def test_heter_embedding_push_is_the_embedding_gradient():
    """The rows pushed in one step are the gradient an nn.Embedding holding
    the same rows gets."""
    ids, y = _heter_batch(1)
    tc = _rec_cluster(tes)
    emb = theter.HeterEmbedding(tc, 0, 8, device='cpu')
    net = _THeterNet(emb)
    uniq = np.unique(ids)
    rows = tc.pull(0, uniq)
    ref = torch.nn.Embedding(len(uniq), 8)
    with torch.no_grad():
        ref.weight.copy_(torch.tensor(rows))
    slots = torch.tensor(np.searchsorted(uniq, ids))
    fc = net.fc

    def head(e):
        return torch.nn.functional.binary_cross_entropy_with_logits(
            fc(e.reshape(e.shape[0], 24)), torch.tensor(y))

    head(net.emb(torch.tensor(ids))).backward()
    head(ref(slots)).backward()
    pushed = np.zeros_like(rows)
    np.add.at(pushed, np.searchsorted(uniq, tc.pushes[0][0]),
              tc.pushes[0][1])
    np.testing.assert_allclose(pushed, ref.weight.grad.numpy(), rtol=0,
                               atol=1e-6)


def test_heter_embedding_through_communicator_in_order():
    ids, y = _heter_batch(2)
    tc = _rec_cluster(tes)
    rec = _Recorder()
    comm = tcomm.AsyncCommunicator(rec, merge_size=1)
    comm.start()
    net = _THeterNet(theter.HeterEmbedding(tc, 0, 8, communicator=comm,
                                           device='cpu'))
    for k in range(3):
        loss = net(torch.tensor(ids + k)).sum()
        loss.backward()
    comm.stop()
    assert [sorted(set(r[1].tolist())) for r in rec.pushes] == \
        [sorted(set((ids + k).reshape(-1).tolist())) for k in range(3)]


def test_pass_cached_embedding_matches_jax():
    ids, y = _heter_batch(3)
    paddle.seed(1)
    jc, tc = _rec_cluster(jes, 4), _rec_cluster(tes, 4)
    jemb = jheter.PassCachedEmbedding(jc, 0, 4)
    temb = theter.PassCachedEmbedding(tc, 0, 4, device='cpu')
    assert jemb.begin_pass(ids) == temb.begin_pass(ids) == \
        len(np.unique(ids))
    jslots = jemb.lookup_slots(ids)
    tslots = temb.lookup_slots(ids)
    np.testing.assert_array_equal(tslots, jslots)
    jfc, tfc = jnn.Linear(4, 1), Linear(4, 1, device='cpu')
    load_paddle_tpu_state(tfc, _state(jfc))
    jopt = paddle.optimizer.SGD(learning_rate=0.5,
                                parameters=[jemb.table] + jfc.parameters())
    topt = tpt.optimizer.SGD(learning_rate=0.5,
                             parameters=[temb.table] + list(tfc.parameters()))
    for _ in range(3):
        from paddle_tpu.tensor import math as tmath
        jloss = JF.binary_cross_entropy_with_logits(
            jfc(tmath.mean(jemb(paddle.to_tensor(jslots)), axis=1)),
            paddle.to_tensor(y))
        jloss.backward()
        tloss = torch.nn.functional.binary_cross_entropy_with_logits(
            tfc(temb(torch.tensor(tslots)).mean(dim=1)), torch.tensor(y))
        tloss.backward()
        np.testing.assert_allclose(temb.table.grad.numpy(),
                                   jemb.table.grad.numpy(), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(tfc.weight.grad.numpy(),
                                   jfc.weight.grad.numpy(), rtol=0,
                                   atol=1e-6)
        jopt.step()
        jopt.clear_grad()
        topt.step()
        topt.clear_grad()
    final = temb.table.detach().numpy().copy()
    base = temb._base.copy()
    assert jemb.end_pass() == temb.end_pass() > 0
    (wi, wd), = jc.deltas
    (gi, gd), = tc.deltas
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, rtol=0, atol=1e-6)
    # exactly the touched rows' deltas
    touched = np.abs(final - base).sum(axis=1) > 0
    np.testing.assert_array_equal(gi, np.unique(ids)[touched])
    np.testing.assert_array_equal(gd, (final - base)[touched])
    assert temb.table is None and 'table' not in dict(
        temb.named_parameters())
    temb.begin_pass(ids)
    with pytest.raises(KeyError, match='working set'):
        temb.lookup_slots(np.asarray([999]))


# ---- the fleet's PS surface ----------------------------------------------


def test_fleet_ps_surface(tmp_path, monkeypatch):
    servers, client = truntime.local_cluster(num_servers=2, dim=4)
    monkeypatch.setattr(truntime, '_PS', dict(truntime._PS))
    try:
        monkeypatch.setenv('PADDLE_TRAINER_ID', '1')
        monkeypatch.setenv('PADDLE_TRAINER_ENDPOINTS', 'a:1,b:2,c:3')
        monkeypatch.setenv('PADDLE_PSERVERS_IP_PORT_LIST', ','.join(
            '127.0.0.1:%d' % s.port for s in servers))
        tfleet.init(role_maker=tfleet.UserDefinedRoleMaker(current_id=1,
                                                           worker_num=3))
        assert (tfleet.worker_index(), tfleet.worker_num()) == (1, 3)
        assert tfleet.is_worker() and not tfleet.is_server()
        assert not tfleet.is_first_worker()
        assert tfleet.worker_endpoints(to_string=True) == 'a:1,b:2,c:3'
        assert len(tfleet.server_endpoints()) == 2
        tfleet.init_worker()
        cli = truntime.get_client()
        assert cli is not None
        rows = cli.pull(0, [1, 2, 3])
        np.testing.assert_array_equal(rows, client.pull(0, [1, 2, 3]))
        tfleet.barrier_worker()       # no barrier table id: a no-op
        tfleet.save_persistables(None, str(tmp_path))
        for s in range(2):
            assert os.path.exists(tmp_path / 'table_0' / ('shard_%d' % s)
                                  / 'shard.npz')
        tfleet.stop_worker()
        assert truntime.get_client() is None
        # the collective surface (ported with the collective slice):
        # without a PS client save_persistables writes the fleet model,
        # and without one registered it raises, as the JAX package does
        monkeypatch.setattr(tfleet, '_FLEET', dict(tfleet._FLEET))
        inner = object()
        assert tfleet.distributed_optimizer(inner)._inner is inner
        assert tfleet.distributed_model(None) is None
        with pytest.raises(RuntimeError, match='no fleet model'):
            tfleet.save_persistables(None, str(tmp_path))
    finally:
        for s in servers:
            s.stop()


# ---- journaled shard recovery --------------------------------------------


def _embedding_server(mod, port=0):
    s = mod.EmbeddingServer(port=port)
    s.create_table(0, dim=4, optimizer='sgd', lr=0.1, seed=7)
    s.start()
    return s


def _recovery(es, sup, chaos_mod, tmp_path):
    reg = MetricRegistry()
    holder = {'srv': _embedding_server(es)}
    port = holder['srv'].port

    def restart():
        holder['srv'] = _embedding_server(es, port)

    journal = sup.PushJournal('trainer-0', registry=reg) \
        if sup is tsup else sup.PushJournal('trainer-0')
    cli = es.EmbeddingClient(endpoints=['127.0.0.1:%d' % port],
                             journal=journal)
    rng = np.random.RandomState(0)
    ids = list(range(32))
    try:
        cli.pull(0, ids)
        for _ in range(3):
            cli.push(0, ids, rng.randn(32, 4).astype(np.float32))
        kw = dict(registry=reg) if sup is tsup else {}
        sv = sup.ShardSupervisor(miss_threshold=1, restart_budget=3,
                                 ping_timeout=0.5, **kw)
        sv.add_shard(sup.ShardSpec('emb0', '127.0.0.1:%d' % port,
                                   role='ps', restart=restart,
                                   snapshot_dir=str(tmp_path),
                                   clients=(cli,)))
        sv.snapshot_all()
        assert len(journal) == 0
        for _ in range(2):
            cli.push(0, ids, rng.randn(32, 4).astype(np.float32))
        want = cli.pull(0, ids)
        chaos_mod.kill_server(holder['srv'])
        assert sv.poll() == {'emb0': True}
        got = cli.pull(0, ids)
        return want, got, journal, reg
    finally:
        holder['srv'].stop()


def test_shard_recovery_bitwise_and_matches_jax(tmp_path):
    from paddle_tpu.testing import chaos as jchaos
    jwant, jgot, _, _ = _recovery(jes, jsup, jchaos, tmp_path / 'j')
    want, got, journal, reg = _recovery(tes, tsup, chaos, tmp_path / 't')
    assert np.array_equal(want, got)           # zero double-applies
    np.testing.assert_array_equal(got, jgot)   # the JAX run's rows
    assert (journal.replayed, journal.dedup_hits) == (2, 0)
    fams = {f.name: f for f in reg.collect()}
    assert fams['supervisor_restarts_total'].labels('ps').value() == 1
    count, total = fams['supervisor_recover_seconds'].value()
    assert count == 1 and total > 0


def test_push_ack_lost_dedups_exactly_once():
    srv = _embedding_server(tes)
    try:
        journal = tsup.PushJournal('trainer-0', registry=MetricRegistry())
        cli = tes.EmbeddingClient(endpoints=['127.0.0.1:%d' % srv.port],
                                  journal=journal)
        base = cli.pull(0, [1, 2, 3])
        grad = np.ones((3, 4), np.float32)
        with chaos.drop_connections(endpoint=str(srv.port), point='recv',
                                    times=1) as fault:
            cli.push(0, [1, 2, 3], grad)
        assert fault.fired == 1 and journal.dedup_hits == 1
        np.testing.assert_array_equal(cli.pull(0, [1, 2, 3]),
                                      base - np.float32(0.1) * grad)
    finally:
        srv.stop()


def test_escalation_aborts_after_restart_budget(tmp_path):
    srv = _embedding_server(tes)
    port = srv.port
    sv = tsup.ShardSupervisor(miss_threshold=1, restart_budget=2,
                              ping_timeout=0.2, registry=MetricRegistry(),
                              backoff=tsup.resilience.RetryPolicy(
                                  base_delay=0.01, max_delay=0.01,
                                  jitter=0.0))
    sv.add_shard(tsup.ShardSpec('emb0', '127.0.0.1:%d' % port,
                                restart=lambda: None,
                                snapshot_dir=str(tmp_path)))
    chaos.kill_server(srv)
    with pytest.raises(tsup.SupervisorAbort, match='2 restart attempts'):
        sv.poll()
    assert not sv.alive('emb0')
