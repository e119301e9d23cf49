"""Process topology (counterpart of paddle_tpu/distributed/topology.py;
reference: fleet/base/topology.py:36 CommunicateTopology + :117
HybridCommunicateGroup).

The JAX package's topology is a jax Mesh over every device of its one
process. Here it is a torch DeviceMesh over the ranks of the job (one
process a rank), with the same axes in the same order, outer to inner:
dp (data), pp (pipeline), sharding (ZeRO), ep (experts), mp (tensor), sp
(sequence). A rank's coordinate on an axis is its rank in that axis's
sub-group; a Group wraps the sub-group's torch ProcessGroup.
`flat_group(mesh, axes)` is the group of the ranks that differ only in
the axes named (the ranks a batch sharded over those axes spreads over).
`pp_line(mesh)` is this rank's pipeline neighbourhood (its stage, the
previous and next stage's global ranks) and `stage_group(mesh, stages)`
the group of the named stages of this rank's pipeline line: the tied
weights of the first and the last stage reduce their grads over it.
"""
import collections

import numpy as np
import torch.distributed as dist

from . import env as env_mod

__all__ = ['CommunicateTopology', 'HybridCommunicateGroup', 'Group',
           'get_hybrid_communicate_group', 'set_hybrid_communicate_group',
           'default_mesh', 'flat_group', 'pp_line', 'stage_group', 'AXES']

AXES = _AXES = ('dp', 'pp', 'sharding', 'ep', 'mp', 'sp')


class CommunicateTopology:
    def __init__(self, hybrid_group_names=('data', 'pipe', 'sharding',
                                           'model'), dims=(1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = collections.namedtuple('Coordinate',
                                                 self._parallel_names)

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    def world_size(self):
        return int(np.prod(self._dims))

    def get_rank(self, **args):
        idx = [args[name] for name in self._parallel_names]
        return int(np.ravel_multi_index(idx, self._dims))

    def get_coord(self, rank):
        return self.coordinate(*np.unravel_index(rank, self._dims))


class Group:
    """A communicator: the ranks of a mesh axis (or any rank list) and
    their torch ProcessGroup. `rank` is this process's index in `ranks`
    (-1 outside the group). Without a process group (one rank, nothing
    initialised) the collectives treat it as a world of one, as the JAX
    package's eager collectives do."""

    def __init__(self, axis_name, nranks, ranks=None, gid=0, pg=None):
        self.axis_name = axis_name
        self.nranks = nranks
        self.ranks = list(ranks) if ranks is not None else \
            list(range(nranks))
        self.id = gid
        self.pg = pg
        me = env_mod.get_rank()
        self.rank = self.ranks.index(me) if me in self.ranks else -1

    @property
    def world_size(self):
        return self.nranks

    def __repr__(self):
        return 'Group(axis=%s, nranks=%d)' % (self.axis_name, self.nranks)


def _axis_group(mesh, axis):
    pg = mesh.get_group(axis)
    return Group(axis, mesh.size(mesh.mesh_dim_names.index(axis)),
                 ranks=dist.get_process_group_ranks(pg), pg=pg)


_FLAT = {}


def flat_group(mesh, axes):
    """The Group of this rank's slice of `mesh` over `axes` (a tuple of
    axis names): the ranks whose coordinates differ only there, ordered
    row-major over `axes` as a PartitionSpec tuple orders them. Every
    rank must call it with the same arguments (new_group is
    collective); the groups are cached per mesh and axes."""
    axes = tuple(axes)
    key = (id(mesh), axes)
    if key in _FLAT:
        return _FLAT[key][1]
    names = list(mesh.mesh_dim_names)
    ranks = np.asarray(mesh.mesh.cpu())
    if len(axes) == 1:
        group = _axis_group(mesh, axes[0])
    else:
        order = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in order]
        moved = np.transpose(ranks, rest + order).reshape(
            -1, int(np.prod([ranks.shape[i] for i in order]) if order
                    else 1))
        me = env_mod.get_rank()
        group = None
        for row in moved:
            row = [int(r) for r in row]
            pg = dist.new_group(row)
            if me in row:
                group = Group(axes, len(row), ranks=row, pg=pg)
    # the entry holds the mesh: a mesh collected while its key stayed
    # would free its id for a later mesh, and a rank that reused it would
    # skip the new_group calls the other ranks make
    _FLAT[key] = (mesh, group)
    return group


PPLine = collections.namedtuple('PPLine', 'stage n_stages prev next ranks')


def pp_line(mesh, axis='pp'):
    """This rank's place on its pipeline line (the ranks that differ only
    on `axis`): PPLine(stage, n_stages, prev, next, ranks), prev / next the
    global ranks of the neighbouring stages (None at the ends) and ranks
    the line's global ranks by stage. A mesh without the axis is one
    stage."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return PPLine(0, 1, None, None, [env_mod.get_rank()])
    ranks = [int(r) for r in dist.get_process_group_ranks(
        mesh.get_group(axis))]
    stage = mesh.get_local_rank(axis)
    n = len(ranks)
    return PPLine(stage, n, ranks[stage - 1] if stage > 0 else None,
                  ranks[stage + 1] if stage < n - 1 else None, ranks)


def stage_group(mesh, stages, axis='pp'):
    """The Group of `stages` (stage indices) on this rank's pipeline
    line, or None when this rank's stage is not among them or they are
    one stage. Every rank calls it with the same arguments (new_group is
    collective: a group is made for every line of the mesh); cached per
    mesh and stages."""
    stages = tuple(sorted(set(stages)))
    key = (id(mesh), axis, stages)
    if key in _FLAT:
        return _FLAT[key][1]
    group = None
    if len(stages) > 1:
        names = list(mesh.mesh_dim_names)
        ranks = np.asarray(mesh.mesh.cpu())
        i = names.index(axis)
        lines = np.moveaxis(ranks, i, -1).reshape(-1, ranks.shape[i])
        me = env_mod.get_rank()
        for line in lines:
            row = [int(line[s]) for s in stages]
            pg = dist.new_group(row)
            if me in row:
                group = Group(axis, len(row), ranks=row, pg=pg)
    _FLAT[key] = (mesh, group)
    return group


class HybridCommunicateGroup:
    """The job's device mesh over the axes dp, pp, sharding, ep, mp, sp
    (reference topology.py:123-136 accessors). The product of the
    degrees must equal the world size (ValueError otherwise); dp_degree
    -1 / 0 / None takes what the others leave. The default process group
    starts here (init_parallel_env) when nothing started it. `devices`,
    when given, is the list of this job's devices (its length must be the
    world size); the mesh takes the device type of this rank."""

    def __init__(self, dp_degree=1, mp_degree=1, pp_degree=1,
                 sharding_degree=1, sp_degree=1, ep_degree=1, devices=None):
        from torch.distributed.device_mesh import init_device_mesh
        if not dist.is_initialized():
            env_mod.init_parallel_env()
        n = dist.get_world_size()
        if devices is not None and len(devices) != n:
            raise ValueError('%d devices given for a world of %d ranks'
                             % (len(devices), n))
        degrees = {'dp': dp_degree, 'pp': pp_degree,
                   'sharding': sharding_degree, 'mp': mp_degree,
                   'sp': sp_degree, 'ep': ep_degree}
        if dp_degree in (0, -1, None):
            rest = int(np.prod([max(1, degrees[a]) for a in
                                ('pp', 'sharding', 'ep', 'mp', 'sp')]))
            degrees['dp'] = max(1, n // rest)
        total = int(np.prod([max(1, degrees[a]) for a in _AXES]))
        if total != n:
            raise ValueError(
                "product of parallel degrees %s != device count %d"
                % (degrees, n))
        self._degrees = {a: max(1, int(degrees[a])) for a in _AXES}
        shape = tuple(self._degrees[a] for a in _AXES)
        device = env_mod.local_device()
        self.mesh = init_device_mesh(device.type, shape,
                                     mesh_dim_names=_AXES)
        self.nranks = n
        self.global_rank = dist.get_rank()
        self._groups = {}

    def _group(self, axis):
        if axis not in self._groups:
            self._groups[axis] = _axis_group(self.mesh, axis)
        return self._groups[axis]

    def _rank(self, axis):
        return self.mesh.get_local_rank(axis)

    # -- per-axis accessors (reference names) -------------------------------
    def get_data_parallel_world_size(self):
        return self._degrees['dp']

    def get_model_parallel_world_size(self):
        return self._degrees['mp']

    def get_pipe_parallel_world_size(self):
        return self._degrees['pp']

    def get_sharding_parallel_world_size(self):
        return self._degrees['sharding']

    def get_sequence_parallel_world_size(self):
        return self._degrees['sp']

    def get_expert_parallel_world_size(self):
        return self._degrees['ep']

    def get_data_parallel_rank(self):
        return self._rank('dp')

    def get_model_parallel_rank(self):
        return self._rank('mp')

    def get_stage_id(self):
        return self._rank('pp')

    def get_sharding_parallel_rank(self):
        return self._rank('sharding')

    def get_sequence_parallel_rank(self):
        return self._rank('sp')

    def get_expert_parallel_rank(self):
        return self._rank('ep')

    def get_global_rank(self):
        return self.global_rank

    # -- pipeline neighbours (reference topology.py:183-199) -----------------
    @property
    def is_first_stage(self):
        return self._rank('pp') == 0

    @property
    def is_last_stage(self):
        return self._rank('pp') == self._degrees['pp'] - 1

    def get_p2p_prev_rank(self):
        """The previous stage's global rank (None on the first stage)."""
        return pp_line(self.mesh).prev

    def get_p2p_next_rank(self):
        """The next stage's global rank (None on the last stage)."""
        return pp_line(self.mesh).next

    def get_pipe_tied_group(self):
        """The group of this line's first and last stage, over which a
        weight both use (the GPT's tied embedding) sums its grads; None
        on a middle stage or a one-stage pipeline."""
        return stage_group(self.mesh, (0, self._degrees['pp'] - 1))

    def topology(self):
        return CommunicateTopology(
            ('data', 'pipe', 'sharding', 'model'),
            (self._degrees['dp'], self._degrees['pp'],
             self._degrees['sharding'], self._degrees['mp']))

    # group objects for the collective API
    def get_data_parallel_group(self):
        return self._group('dp')

    def get_model_parallel_group(self):
        return self._group('mp')

    def get_pipe_parallel_group(self):
        return self._group('pp')

    def get_sharding_parallel_group(self):
        return self._group('sharding')

    def get_sequence_parallel_group(self):
        return self._group('sp')

    def get_expert_parallel_group(self):
        return self._group('ep')

    def get_check_parallel_group(self):
        return Group(None, self.nranks, ranks=list(range(self.nranks)),
                     pg=dist.group.WORLD)


_GLOBAL_HCG = [None]


def set_hybrid_communicate_group(hcg):
    _GLOBAL_HCG[0] = hcg


def get_hybrid_communicate_group():
    return _GLOBAL_HCG[0]


def default_mesh(axis='dp', devices=None):
    """A one-axis mesh over every rank (pure data parallelism)."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        env_mod.init_parallel_env()
    return init_device_mesh(env_mod.local_device().type,
                            (dist.get_world_size(),),
                            mesh_dim_names=(axis,))


def mesh_axis_size(mesh, axis):
    """The size of `axis` in `mesh` (1 when the mesh has no such axis)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_coords(mesh, axes):
    """This rank's flat index over `axes` (row-major) and their product."""
    idx, total = 0, 1
    for a in axes:
        size = mesh_axis_size(mesh, a)
        idx = idx * size + (mesh.get_local_rank(a)
                            if a in (mesh.mesh_dim_names or ()) else 0)
        total *= size
    return idx, total

