"""The port's collectives, topology, spawn and DataParallel
(paddle_tpu_torch/distributed/{collective,topology,spawn,parallel}.py)
in gloo worlds of CPU ranks, against numpy and the JAX package's
HybridCommunicateGroup at the same degrees; fleet.utils.LocalFS in
process. One process a rank: the rank bodies are in torch_dist_bodies.py
(nothing there imports jax)."""
import numpy as np
import pytest

import jax

from paddle_tpu.distributed import HybridCommunicateGroup as JaxHCG

import torch_dist_bodies as bodies

WORLD = 2
# the degrees of each HybridCommunicateGroup built in the world of 4
HCG_DEGREES = [dict(dp_degree=2, mp_degree=2),
               dict(dp_degree=2, sharding_degree=2),
               dict(dp_degree=-1, sp_degree=2),
               dict(dp_degree=1, mp_degree=2, sp_degree=2),
               dict(dp_degree=3)]


@pytest.fixture(scope='module')
def shared_root(tmp_path_factory):
    return bodies.shared_root(tmp_path_factory)


@pytest.fixture(scope='module')
def world2(shared_root):
    rng = np.random.RandomState(0)
    dp = {'kind': 'data_parallel',
          'w': rng.standard_normal((5, 3)).astype(np.float32),
          'x': rng.standard_normal((4, 5)).astype(np.float32)}
    job = {'sections': [('collectives', {'kind': 'collectives'}),
                        ('data_parallel', dp)]}
    return bodies.world_results(shared_root, 'collective2', WORLD, job), dp


@pytest.fixture(scope='module')
def world4(shared_root):
    job = {'sections': [('hcg', {'kind': 'hcg', 'degrees': HCG_DEGREES}),
                        ('flat_cache', {'kind': 'flat_cache',
                                        'degrees': FLAT_DEGREES})]}
    return bodies.world_results(shared_root, 'collective4', 4, job)


# two layouts in turn, then the first again: ('dp', 'sharding') is every
# rank under dp 2 x sharding 2 and the dp pair under dp 2 x mp 2
FLAT_DEGREES = [{'dp_degree': 2, 'sharding_degree': 2},
                {'dp_degree': 2, 'mp_degree': 2},
                {'dp_degree': 2, 'sharding_degree': 2}]


def test_flat_group_cache_holds_its_meshes(world4):
    """flat_group caches its groups per mesh, and the entry keeps the mesh
    alive: a collected mesh would free its id for a later mesh, and the
    ranks that drew it would skip the new_group calls the others make.
    Each layout gets its own groups."""
    got = bodies.section(world4, 'flat_cache')
    for rank in range(4):
        want = [[0, 1, 2, 3], [rank % 2, rank % 2 + 2], [0, 1, 2, 3]]
        assert [g['ranks'] for g in got[rank]] == want
        assert all(g['alive'] for g in got[rank])


def _base(rank):
    return np.arange(6.0, dtype=np.float32).reshape(2, 3) + 10 * rank + 1


def _expected(name, rank):
    bases = [_base(r) for r in range(WORLD)]
    return {
        'all_reduce_sum': sum(bases), 'all_reduce_max': np.max(bases, 0),
        'all_reduce_min': np.min(bases, 0),
        'all_reduce_prod': np.prod(bases, 0),
        'all_reduce_avg': sum(bases) / WORLD,
        'all_gather': np.stack(bases), 'broadcast': bases[-1],
        'reduce': sum(bases) if rank == 0 else None,
        'scatter': np.full((2, 3), float(rank)),
        'alltoall': np.stack([np.full(3, 100.0 * r + rank)
                              for r in range(WORLD)]),
        'send_recv': bases[0] * 2 if rank == 1 else bases[rank],
        'p2p_shift': bases[(rank - 1) % WORLD],
        # y on rank r is x of rank r - 1, weighted by r + 1: x's grad on
        # rank r comes from rank r + 1
        'p2p_shift_grad': np.full((2, 3), float((rank + 1) % WORLD + 1)),
    }[name]


COLLECTIVES = ['all_reduce_sum', 'all_reduce_max', 'all_reduce_min',
               'all_reduce_prod', 'all_reduce_avg', 'all_gather',
               'broadcast', 'reduce', 'scatter', 'alltoall', 'send_recv',
               'p2p_shift', 'p2p_shift_grad']


@pytest.mark.parametrize('name', COLLECTIVES)
def test_collective_against_numpy(world2, name):
    got = bodies.section(world2[0], 'collectives')
    for rank in range(WORLD):
        want = _expected(name, rank)
        if want is None:
            continue
        np.testing.assert_allclose(got[rank][name], want, rtol=1e-6,
                                   err_msg='%s on rank %d' % (name, rank))


def test_new_group_and_get_group(world2):
    got = bodies.section(world2[0], 'collectives')
    for rank in range(WORLD):
        reduced, ranks, group_rank = got[rank]['new_group']
        np.testing.assert_allclose(reduced, sum(_base(r)
                                                for r in range(WORLD)))
        assert ranks == list(range(WORLD)) and group_rank == rank


def test_spawn_env_contract(world2):
    envs = {r: res['env'] for r, res in world2[0].items()}
    endpoints = envs[0]['PADDLE_TRAINER_ENDPOINTS'].split(',')
    assert len(endpoints) == WORLD
    for rank, env in envs.items():
        assert env['PADDLE_TRAINER_ID'] == str(rank)
        assert env['PADDLE_TRAINERS_NUM'] == str(WORLD)
        assert env['PADDLE_CURRENT_ENDPOINT'] == endpoints[rank]
        assert env['PADDLE_TRAINER_ENDPOINTS'] == ','.join(endpoints)
        assert env['PADDLE_DISTRI_BACKEND'] == 'gloo'
        assert env['PADDLE_DISTRI_DEVICE'] == 'cpu'


def test_spawn_propagates_a_rank_failure():
    from paddle_tpu_torch.distributed import spawn
    with pytest.raises(RuntimeError, match='rank 1 fails on purpose'):
        spawn(bodies.fail_on_rank, args=(1,), nprocs=2, backend='gloo',
              env={'OMP_NUM_THREADS': '1'})


def test_spawn_one_process_runs_inline():
    from paddle_tpu_torch.distributed import spawn
    seen = []
    assert spawn(seen.append, args=(7,), nprocs=1) is None
    assert seen == [7]


def test_data_parallel_averages_grads(world2):
    results, spec = world2
    got = bodies.section(results, 'data_parallel')
    w, x = spec['w'], spec['x']
    # the mean over all rows of (x w)^2: grad 2 x^T (x w) / rows, as [out, in]
    want = (2.0 * x.T @ (x @ w) / (x.shape[0] * w.shape[1])).T
    for rank in range(WORLD):
        np.testing.assert_allclose(got[rank]['synced'], want, rtol=1e-5,
                                   atol=1e-6)
        # no_sync: the local grad of sum(x0 w) only, on each rank alike
        np.testing.assert_allclose(got[rank]['no_sync_delta'],
                                   np.tile(x[0], (w.shape[1], 1)),
                                   rtol=1e-5, atol=1e-6)
        assert got[rank]['state_keys'] == ['bias', 'weight']


def _jax_coords(jhcg, rank):
    ids = np.vectorize(lambda d: d.id)(jhcg.mesh.devices)
    return dict(zip(jhcg.mesh.axis_names, np.argwhere(ids == rank)[0]))


@pytest.mark.parametrize('index', range(len(HCG_DEGREES)))
def test_hcg_accessors_match_jax(world4, index):
    got = bodies.section(world4, 'hcg')
    deg = HCG_DEGREES[index]
    devices = jax.devices()[:4]
    try:
        jhcg = JaxHCG(devices=devices, **deg)
    except ValueError as e:
        for rank in range(4):
            assert 'product of parallel degrees' in \
                got[rank][index]['error_value']
        assert 'product of parallel degrees' in str(e)
        return
    for rank in range(4):
        acc = got[rank][index]
        for name, axis in (('data_parallel', 'dp'),
                           ('model_parallel', 'mp'),
                           ('pipe_parallel', 'pp'),
                           ('sharding_parallel', 'sharding'),
                           ('sequence_parallel', 'sp'),
                           ('expert_parallel', 'ep')):
            assert acc[name + '_world_size'] == getattr(
                jhcg, 'get_%s_world_size' % name)(), name
        # the JAX package is one process (its ranks read 0); a rank's
        # coordinate is where its device sits in the JAX mesh
        coords = _jax_coords(jhcg, rank)
        assert acc['data_parallel_rank'] == coords['dp']
        assert acc['model_parallel_rank'] == coords['mp']
        assert acc['sharding_parallel_rank'] == coords['sharding']
        assert acc['sequence_parallel_rank'] == coords['sp']
        assert acc['stage_id'] == coords['pp']
        jtopo = jhcg.topology()
        assert acc['topology_dims'] == [jtopo.get_dim(a) for a in
                                        ('data', 'pipe', 'sharding',
                                         'model')]
        assert acc['check_group'] == [0, 1, 2, 3]
        for axis in ('dp', 'mp', 'sharding', 'sp'):
            members = acc['groups'][axis]
            assert rank in members and len(members) == \
                jhcg.mesh.shape[axis]


def test_local_fs(tmp_path):
    from paddle_tpu_torch.distributed.fleet.utils import LocalFS
    from paddle_tpu.distributed.fleet.utils import LocalFS as JaxLocalFS
    for fs, root in ((LocalFS(), tmp_path / 'port'),
                     (JaxLocalFS(), tmp_path / 'jax')):
        fs.mkdirs(str(root / 'a' / 'b'))
        fs.touch(str(root / 'a' / 'f.txt'))
        assert fs.is_dir(str(root / 'a')) and fs.is_file(
            str(root / 'a' / 'f.txt'))
        fs.mv(str(root / 'a' / 'f.txt'), str(root / 'g.txt'))
        fs.upload(str(root / 'g.txt'), str(root / 'h.txt'))
        listing = fs.ls_dir(str(root))
        fs.delete(str(root / 'a'))
        assert not fs.is_exist(str(root / 'a'))
        assert fs.ls_dir(str(root / 'missing')) == ([], [])
        if fs.__class__ is LocalFS:
            port_listing = (sorted(listing[0]), sorted(listing[1]))
        else:
            assert (sorted(listing[0]), sorted(listing[1])) == port_listing
    assert port_listing == (['a'], ['g.txt', 'h.txt'])


def test_hdfs_client_refuses_hdfs_paths(tmp_path):
    from paddle_tpu_torch.distributed.fleet.utils import HDFSClient
    with pytest.warns(UserWarning, match='LocalFS-backed'):
        fs = HDFSClient()
    with pytest.raises(NotImplementedError, match='no HDFS'):
        fs.is_exist('hdfs://nn/x')
    assert fs.is_exist(str(tmp_path))


def test_collectives_without_a_process_group_act_as_one_rank():
    import torch
    import paddle_tpu_torch.distributed as dist
    assert not torch.distributed.is_initialized()
    x = torch.tensor([1.0, 2.0])
    dist.all_reduce(x, op=dist.ReduceOp.AVG)
    out = []
    dist.all_gather(out, x)
    parts = dist.alltoall([x])
    dist.broadcast(x, src=0)
    assert x.tolist() == [1.0, 2.0] and len(out) == 1
    assert torch.equal(parts[0], x)
