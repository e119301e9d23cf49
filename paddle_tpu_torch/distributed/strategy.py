"""Strategy compiler: DistributedStrategy -> shardings for TrainStep
(counterpart of paddle_tpu/distributed/strategy.py).

The JAX package turns each strategy into PartitionSpecs over its mesh and
lets XLA's SPMD partitioner insert the collectives. The port keeps the
same specs (`PartitionSpec`, `NamedSharding` over a DeviceMesh) and the
same rules for choosing them, and carries them out itself:

  data_parallel      -> batch P('dp'), params replicated (plain tensors)
                        => TrainStep averages the grads over 'dp'
  sharding, stage 3  -> FSDP2 fully_shard over the 'sharding' axis (HSDP
                        with 'dp'): params, grads and slots sharded
  sharding, stage 1/2-> slots sharded on dim 0 over 'sharding': each rank
                        updates its rows and the rows are all-gathered
  tensor_parallel    -> the 'mp' placement hints of the TP layers and the
                        GPT as DTensor Shard / Replicate placements; the
                        layers compute on their local shards
                        (meta_parallel/mp_layers.py)
  sequence_parallel  -> the batch's dim 1 over 'sp'; attention runs as
                        ring / Ulysses over the sp group (sp.py)

A placement hint on an axis of size 1 is dropped, as the JAX package
drops it, except 'mp' under strategy['tensor_parallel'], which stays a
DTensor placement over a one-rank axis so the TP path runs at any degree.
"""
import torch
from torch import nn

__all__ = ['PartitionSpec', 'P', 'NamedSharding', 'build_shardings',
           'place_params', 'place_opt_slots', 'shard_params_for_zero3']

_META = ('placement', 'is_distributed', 'optimize_attr', 'regularizer',
         'need_clip', 'trainable', 'param_name', 'do_model_average')


class PartitionSpec(tuple):
    """jax.sharding.PartitionSpec's shape: one entry per tensor dim, each
    None, an axis name or a tuple of axis names (major to minor)."""

    def __new__(cls, *dims):
        return tuple.__new__(cls, dims)

    def __repr__(self):
        return 'P%s' % (tuple.__repr__(self),)


P = PartitionSpec


def _axes_of(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


class NamedSharding:
    """A PartitionSpec over a DeviceMesh."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else \
            PartitionSpec(*spec)

    def __repr__(self):
        return 'NamedSharding(%r)' % (self.spec,)

    def axes(self):
        return tuple(a for e in self.spec for a in _axes_of(e))

    def is_replicated(self):
        return not self.axes()

    def placements(self, mesh=None):
        """DTensor placements, one per dim of `mesh` (this sharding's
        mesh by default)."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for name in (mesh or self.mesh).mesh_dim_names:
            dims = [i for i, e in enumerate(self.spec) if name in _axes_of(e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return out

    def submesh(self):
        """The mesh over only the axes this sharding uses, in mesh order
        (a DTensor over it propagates its sharding over those axes alone,
        where one over the whole six-axis mesh would enumerate all)."""
        used = set(self.axes())
        names = tuple(n for n in self.mesh.mesh_dim_names if n in used)
        if not names or names == tuple(self.mesh.mesh_dim_names):
            return self.mesh
        return self.mesh[names]

    def local(self, tensor, dim_layouts=None):
        """This rank's block of the global `tensor`. dim_layouts[i], when
        given, maps a dim to a function (tensor, index, count) -> block
        that replaces the contiguous split (sp's zigzag layout)."""
        from .topology import axis_coords
        for i, entry in enumerate(self.spec):
            axes = _axes_of(entry)
            if not axes or i >= tensor.dim():
                continue
            idx, total = axis_coords(self.mesh, axes)
            if total == 1:
                continue
            size = tensor.shape[i]
            if size % total:
                raise ValueError('dim %d of size %d does not split over %s '
                                 '(%d ranks)' % (i, size, axes, total))
            layout = (dim_layouts or {}).get(i)
            if layout is not None:
                tensor = layout(tensor, idx, total)
            else:
                tensor = tensor.narrow(i, idx * (size // total),
                                       size // total)
        return tensor


def _param_spec(placement, ndim, strategy, name=''):
    """PartitionSpec for a param: TP placement hint (tuple aligned to shape)
    + optional ZeRO-3 sharding of the largest remaining axis."""
    dims = [None] * ndim
    if placement:
        for i, ax in enumerate(placement):
            if ax is not None and i < ndim:
                dims[i] = ax
    if strategy.get('zero_stage', 0) >= 3 and ndim >= 1:
        for i in range(ndim):
            if dims[i] is None:
                dims[i] = 'sharding'
                break
    return P(*dims)


def _axis_size(mesh, axis):
    from .topology import mesh_axis_size
    return mesh_axis_size(mesh, axis)


def _keeps(mesh, axis, strategy):
    if axis not in (mesh.mesh_dim_names or ()):
        return False
    if _axis_size(mesh, axis) > 1:
        return True
    return axis == 'mp' and bool(strategy.get('tensor_parallel'))


def build_shardings(model, optimizer, mesh, strategy=None):
    """The shardings for TrainStep, as the JAX package's build_shardings
    returns them: {'mesh', 'in_shardings' (None), 'out_shardings'
    ((params, buffers, opt_state, loss) shardings), 'batch_sharding',
    'param_shardings'}.

    strategy keys: zero_stage (0/1/2/3), tensor_parallel (bool),
    sequence_parallel (bool), amp_dtype, gradient_merge_k."""
    strategy = strategy or {}
    named = list(model.named_parameters())

    def ns(spec):
        return NamedSharding(mesh, spec)

    replicated = ns(P())
    param_shardings = {}
    for name, p in named:
        placement = getattr(p, 'placement', None)
        if placement:
            placement = tuple(ax if _keeps(mesh, ax, strategy) else None
                              for ax in placement)
            if not any(placement):
                placement = None
        spec = _param_spec(placement, p.dim(), strategy, name)
        dims = []
        for i, ax in enumerate(spec):
            # avoid sharding axes not divisible
            if ax is not None and p.shape[i] % _axis_size(mesh, ax) != 0:
                dims.append(None)
            else:
                dims.append(ax)
        param_shardings[name] = ns(P(*dims))

    buffer_shardings = {name: replicated for name, _ in
                        model.named_buffers()}
    zero = strategy.get('zero_stage', 0)
    n_shard = _axis_size(mesh, 'sharding')

    def slot_sharding_for(name, p):
        if zero >= 1 and zero < 3 and p.dim() >= 1 and n_shard > 1 and \
                p.shape[0] % n_shard == 0:
            # shard optimizer state over the sharding axis on dim 0
            return ns(P('sharding'))
        return param_shardings[name]

    trainable = [(n, p) for n, p in named if p.requires_grad]
    slots = {}
    for name, p in trainable:
        names = list(optimizer._init_slots(p)) if optimizer is not None \
            else []
        slots[name] = {k: slot_sharding_for(name, p) for k in names}
    opt_shardings = {'slots': slots, 'step': replicated}
    if strategy.get('amp_dtype') == 'float16':
        opt_shardings['loss_scale'] = replicated
        opt_shardings['growth'] = replicated
    if strategy.get('gradient_merge_k', 1) > 1:
        opt_shardings['acc'] = {name: param_shardings[name]
                                for name, _ in trainable}
        opt_shardings['micro'] = replicated

    batch_axes = ['dp']
    if n_shard > 1:
        # ZeRO composes with dp over the batch: both axes on dim 0
        batch_axes = [('dp', 'sharding')]
    if strategy.get('sequence_parallel') and _axis_size(mesh, 'sp') > 1:
        # long context: dim 1 (sequence) over 'sp'; attention runs as
        # ring / Ulysses through the sp state (distributed/sp.py)
        batch_axes = batch_axes + ['sp']
    batch_sharding = ns(P(*batch_axes))
    out_shardings = (param_shardings, buffer_shardings, opt_shardings,
                     replicated)
    return {
        'mesh': mesh,
        'in_shardings': None,
        'out_shardings': out_shardings,
        'batch_sharding': batch_sharding,
        'param_shardings': param_shardings,
    }


def _copy_meta(src, dst):
    for key in _META:
        if hasattr(src, key):
            setattr(dst, key, getattr(src, key))


def _replace_params(model, make):
    """Swap each parameter p of model's modules for make(name, p) (None
    keeps it); shared parameters are swapped once. Returns {id(old): new}."""
    swapped = {}
    for name, p in list(model.named_parameters(remove_duplicate=True)):
        new = make(name, p)
        if new is not None:
            _copy_meta(p, new)
            swapped[id(p)] = new
    if not swapped:
        return swapped
    for module in model.modules():
        for key, p in list(module._parameters.items()):
            if p is not None and id(p) in swapped:
                module._parameters[key] = swapped[id(p)]
    return swapped


def _fsdp_mesh(mesh):
    names = mesh.mesh_dim_names
    if _axis_size(mesh, 'dp') > 1:
        return mesh['dp', 'sharding']
    return mesh['sharding'] if 'sharding' in names else mesh


def is_fully_sharded(model):
    from torch.distributed.fsdp import FSDPModule
    return isinstance(model, FSDPModule)


def _fully_shard(model, mesh, amp_dtype=None):
    """FSDP2 over the mesh's 'sharding' axis ('dp' x 'sharding' as HSDP
    when dp > 1): each block of a ModuleList a unit, then the root. With
    amp_dtype, the parameters are gathered in it for the forward and the
    backward and the grads reduced in f32 (the TrainStep's AMP)."""
    from torch.distributed.fsdp import (FSDPModule, MixedPrecisionPolicy,
                                        fully_shard)
    if isinstance(model, FSDPModule):
        return model
    kwargs = {'mesh': _fsdp_mesh(mesh)}
    if amp_dtype is not None:
        kwargs['mp_policy'] = MixedPrecisionPolicy(
            param_dtype=amp_dtype, reduce_dtype=torch.float32)
    metas = {name: p for name, p in model.named_parameters()}
    for module in list(model.modules()):
        if isinstance(module, nn.ModuleList):
            for block in module:
                fully_shard(block, **kwargs)
    fully_shard(model, **kwargs)
    for name, p in model.named_parameters():
        if name in metas:
            _copy_meta(metas[name], p)
    return model


def place_params(model, param_shardings, amp_dtype=None):
    """Lay every parameter out as its sharding says (pre-step layout):
    specs over 'sharding' (ZeRO-3) take FSDP2 over the sharding axis;
    other sharded specs ('mp', ...) make the parameter a DTensor over the
    mesh of the axes they use with the spec's placements (rank 0's values
    scattered); replicated ones stay plain tensors. Returns {id(old parameter): new}."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    zero3 = any('sharding' in s.axes() for s in param_shardings.values())
    other = {n: s for n, s in param_shardings.items()
             if not s.is_replicated() and set(s.axes()) - {'sharding'}}
    if zero3 and other:
        raise NotImplementedError(
            'ZeRO stage 3 composed with tensor-parallel placements is not '
            'ported yet (ROADMAP Queue 1 item 3, ZeRO-3 with mp)')
    if zero3:
        mesh = next(iter(param_shardings.values())).mesh
        before = {id(p): n for n, p in model.named_parameters()}
        _fully_shard(model, mesh, amp_dtype)
        after = dict(model.named_parameters())
        return {i: after[n] for i, n in before.items() if n in after}

    def make(name, p):
        sh = other.get(name)
        if sh is None or isinstance(p.data, DTensor):
            return None
        mesh = sh.submesh()
        dt = distribute_tensor(p.detach(), mesh, sh.placements(mesh))
        return nn.Parameter(dt, requires_grad=p.requires_grad)

    return _replace_params(model, make)


def place_opt_slots(model, optimizer, opt_shardings, swapped=None):
    """Point the optimizer at the placed parameters (`swapped`, what
    place_params returned), their slots with them, and record the slot
    shardings as optimizer._slot_shardings. A slot sharded over 'sharding'
    (ZeRO-1/2) is held for this rank's dim-0 rows, which TrainStep
    updates; slots of a sharded parameter are held for its local shard.
    TrainStep slices the global slots kept here on its first update."""
    swapped = swapped or {}
    if optimizer._parameter_list is not None and swapped:
        plist = []
        for p in optimizer._parameter_list:
            new = swapped.get(id(p), p)
            if new is not p:
                optimizer._names[id(new)] = optimizer._names.pop(id(p))
                if id(p) in optimizer._explicit_names:
                    optimizer._explicit_names.discard(id(p))
                    optimizer._explicit_names.add(id(new))
                if id(p) in optimizer._slots:
                    optimizer._slots[id(new)] = optimizer._slots.pop(id(p))
            plist.append(new)
        optimizer._parameter_list = plist
    optimizer._slot_shardings = dict(opt_shardings.get('slots', {}))


def shard_params_for_zero3(model, mesh):
    """FSDP2 over the mesh's sharding axis (ZeRO-3)."""
    return place_params(model, build_shardings(
        model, None, mesh, {'zero_stage': 3})['param_shardings'])
