"""The training step (counterpart of paddle_tpu/framework/functional.py's
TrainStep).

The JAX package traces forward, backward and update into one jitted XLA
program. The port runs them eagerly: model.train(), forward,
loss_fn(*outputs, *labels), backward, then the optimizer update in the
order of the JAX step's apply_updates (grad clip; coupled decay and the
parameters' regularizers; their learning rates; decoupled decay on the
stored operand; the rule; the cast back to the parameter's dtype; the step
count t = step + 1).

The JAX step's options, each as it does it:
- amp_dtype ('bfloat16' / 'float16'): the parameters (trainable or
  not), the floating buffers and the floating inputs are cast to it for
  the forward and the backward (the parameters' storage swapped for the
  cast copies for the step); the grads return in the parameters' dtype,
  the buffers are cast back, and the loss is taken in f32.
- fp16 dynamic loss scaling (amp_dtype='float16'): the f32 loss times the
  scale is differentiated and the grads divided by it; a non-finite grad
  skips the update (parameters, slots and step count stay as they were)
  and halves the scale, to a floor of 1; ls_growth_interval finite steps
  in a row double it, to a cap of 2^24. The finite check is one fused
  reduction and one flag read to the host a step (the JAX step decides
  on the device with lax.cond).
- remat: the whole loss is checkpointed (torch.utils.checkpoint,
  non-reentrant): the backward runs the forward again.
- k_steps / grad_merge_avg: the grads are summed over k_steps calls, in
  f32 for 16-bit parameters; on the k-th call clip, decay and the update
  run on the sum (times 1 / k_steps when grad_merge_avg), and only then
  does the step count advance. fp16 loss scaling with k_steps > 1
  raises, as in the JAX package.

The distributed options, one process a rank (the JAX step is one SPMD
program over a mesh; distributed/strategy.py builds the same specs):
- batch_sharding (a NamedSharding over a DeviceMesh, e.g.
  P(('dp', 'sharding'), 'sp')): the caller passes the global batch, as in
  the JAX package, and each rank keeps its block. The loss returned is
  the mean over the ranks that hold different rows, and the grads are
  averaged over them (FSDP2 averages its own axes), as the JAX step's
  grads of a batch-sharded mean are. Under an sp state in the zigzag mode
  dim 1 is laid out zigzag (distributed/sp.py).
- mesh: the DeviceMesh (the batch sharding's when None).
- in_shardings / out_shardings: the JAX step's pytrees; their parameter
  shardings are applied at construction (place_params: DTensors over
  'mp', FSDP2 over 'sharding'), and slot shardings over 'sharding'
  (ZeRO-1 / 2) make each rank update its dim-0 rows of the parameter,
  holding slots for those rows only, then all-gather the rows. Where
  none are given, the optimizer's (place_opt_slots) are used.
- grad_sync: a function of {name: grad} applied to the averaged grads
  (this rank's shards) before the update.
- sp_state: distributed/sp.py's state, active around the forward and the
  backward (attention as ring / Ulysses over the sp group).
- fce_sharding: the vocab-parallel fused loss for a head sharded over
  'mp' (ops/fused_ce.logits_sharding) around the forward and backward.
- pp_state: distributed/pipeline.py's state, active around the step.
  On a pipeline of more than one stage the model keeps only this rank's
  stage (pipeline.keep_stage); the forward and the backward are the
  schedule's microbatch loop over the 'pp' line, 1F1B when the state asks
  for it and the model has pp_decompose() (else GPipe, with a warning, as
  in the JAX package). The loss is the mean of the microbatch losses,
  broadcast from the last stage; the grads then take the other options'
  path (the data-parallel average, grad_sync, gradient merge, the
  update). `pp_stats` holds the last step's schedule, microbatch count
  and peak of microbatches in flight on this rank.
Under a batch that spreads over ranks the MoE layers route over the
global batch (incubate/moe.py, token_scope).
Sharded parameters update through their local shards; a grad clip sees
the global norm (the shards' squares summed over their ranks). AMP with
tensor-parallel (DTensor) parameters raises; under FSDP2 the storage
swap gives way to FSDP2's MixedPrecisionPolicy (place_params' amp_dtype).
"""
import contextlib

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..amp.grad_scaler import unscale_and_check
from ..optimizer.optimizers import _is_low_precision
from .dtype import to_torch_dtype

__all__ = ['TrainStep']

_MAX_LOSS_SCALE = 2.0 ** 24
_PARAM_META = ('optimize_attr', 'regularizer', 'need_clip', 'param_name')


def _is_dtensor(t):
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _local(t):
    """A DTensor's local shard (the tensor itself otherwise)."""
    return t._local_tensor if _is_dtensor(t) else t


def _shard_group(p):
    """The ProcessGroup whose ranks' local shards of DTensor p partition
    it (None when the local tensor is the whole parameter)."""
    if not _is_dtensor(p):
        return None
    from torch.distributed.tensor import Shard
    mesh = p.device_mesh
    dims = [mesh.mesh_dim_names[i] for i, pl in enumerate(p.placements)
            if isinstance(pl, Shard) and mesh.size(i) > 1]
    if not dims:
        return None
    from ..distributed.topology import flat_group
    return flat_group(mesh, tuple(dims)).pg


class _ShardView:
    """A sharded parameter p as a TrainStep updates it: through `local`,
    its DTensor's local shard or (ZeRO-1 / 2, `group` given) this rank's
    dim-0 rows, whose optimizer slots have local's shape. gather makes a
    slot global (a collective), scatter takes this rank's part of a global
    one (no communication)."""

    def __init__(self, p, local, group=None):
        self.param = p
        self.local = local
        self.group = group

    @torch.no_grad()
    def gather(self, t):
        p = self.param
        if self.group is None:
            from torch.distributed.tensor import DTensor
            return DTensor.from_local(
                t, p.device_mesh, p.placements, shape=p.shape,
                stride=torch.empty(p.shape, device='meta').stride()
            ).full_tensor()
        parts = [torch.empty_like(t) for _ in range(self.group.nranks)]
        dist.all_gather(parts, t.contiguous(), group=self.group.pg)
        return torch.cat(parts)

    @torch.no_grad()
    def scatter(self, t):
        p = self.param
        t = t.to(self.local.device)
        if self.group is None:
            from torch.distributed.tensor import distribute_tensor
            return distribute_tensor(t, p.device_mesh, p.placements,
                                     src_data_rank=None).to_local().clone()
        rows = t.shape[0] // self.group.nranks
        return t.narrow(0, self.group.rank * rows, rows).clone()


class TrainStep:
    def __init__(self, model, loss_fn, optimizer, donate=True,
                 in_shardings=None, out_shardings=None, mesh=None,
                 batch_sharding=None, grad_sync=None, k_steps=1,
                 grad_merge_avg=True, amp_dtype=None, remat=False,
                 sp_state=None, pp_state=None, init_loss_scaling=65536.0,
                 ls_growth_interval=2000, fce_sharding=None):
        self.model = model
        self._pp_state = pp_state
        self.pp_stats = None
        if pp_state is not None:
            pp_state = self._pp_schedule(pp_state)
            if remat:  # the whole-step remat as the stages' layer remat
                pp_state = dict(pp_state, remat=True)
            self._pp_state = pp_state
            from ..distributed.pipeline import keep_stage
            keep_stage(model, pp_state, optimizer)
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._amp_dtype = (None if amp_dtype is None else torch.bfloat16
                           if amp_dtype is True
                           else to_torch_dtype(amp_dtype))
        self._loss_scaling = self._amp_dtype == torch.float16
        self._k_steps = int(k_steps)
        if self._loss_scaling and self._k_steps > 1:
            raise NotImplementedError(
                'fp16 loss scaling is not composed with gradient merge '
                'yet; use bf16 amp with gradient_merge')
        self._grad_merge_avg = grad_merge_avg
        self._remat = bool(remat)
        self.loss_scale = float(init_loss_scaling)
        self._ls_growth = 0
        self._ls_growth_interval = int(ls_growth_interval)
        self._acc = None
        self._micro = 0
        self._mesh = mesh if mesh is not None else getattr(
            batch_sharding, 'mesh', None)
        self._batch_sharding = batch_sharding
        self._grad_sync = grad_sync
        self._sp_state = sp_state
        self._fce_sharding = fce_sharding
        self._setup_layout(in_shardings, out_shardings)
        self._params = [(name, p) for name, p in model.named_parameters()
                        if p.requires_grad]
        self._handles = {}
        if self._amp_dtype is not None and not self._fsdp and any(
                _is_dtensor(p) for _, p in self._params):
            raise NotImplementedError(
                'TrainStep(amp_dtype=...) with tensor-parallel (DTensor) '
                'parameters is not ported yet (ROADMAP Queue 1 item 3, '
                'AMP under tensor parallelism)')

    def _pp_schedule(self, state):
        """The state with the schedule this model can run: 1F1B needs
        pp_decompose(); without it GPipe, as the JAX step falls back."""
        from ..distributed.pipeline_1f1b import supports_1f1b
        if state.get('schedule') != '1f1b' or supports_1f1b(self.model):
            return state
        import warnings
        warnings.warn(
            'pipeline schedule_mode=1F1B needs %s.pp_decompose() '
            '(pre/blocks/post split); falling back to the GPipe schedule'
            % type(self.model).__name__)
        state = dict(state, schedule='gpipe')
        if state.get('n_micro_defaulted'):
            # GPipe's default microbatch count is pp, 1F1B's 2 pp
            state['n_micro'] = state['n_stages']
        return state

    # -- layout ----------------------------------------------------------------
    def _setup_layout(self, in_shardings, out_shardings):
        """Place the parameters as the shardings say, and find the groups
        the batch, the grads and the ZeRO-1 / 2 rows spread over."""
        from ..distributed import strategy as strategy_mod
        shardings = out_shardings or in_shardings
        self._slot_shardings = getattr(self.optimizer, '_slot_shardings',
                                       None) or {}
        if shardings:
            swapped = strategy_mod.place_params(self.model, shardings[0],
                                                self._amp_dtype)
            if len(shardings) > 2 and shardings[2]:
                strategy_mod.place_opt_slots(self.model, self.optimizer,
                                             shardings[2], swapped)
                self._slot_shardings = shardings[2].get('slots', {})
        self._fsdp = strategy_mod.is_fully_sharded(self.model)
        self._data_group = self._grad_group = None
        self._zero = {}
        if self._mesh is None:
            return
        from ..distributed.topology import flat_group, mesh_axis_size
        axes = self._batch_sharding.axes() if self._batch_sharding else ()
        axes = tuple(a for a in axes if mesh_axis_size(self._mesh, a) > 1)
        if axes:
            self._data_group = flat_group(self._mesh, axes)
        grad_axes = tuple(a for a in axes if not (
            self._fsdp and a in ('dp', 'sharding')))
        if grad_axes:
            self._grad_group = flat_group(self._mesh, grad_axes)
        if mesh_axis_size(self._mesh, 'sharding') > 1 and not self._fsdp:
            group = flat_group(self._mesh, ('sharding',))
            for name, slots in self._slot_shardings.items():
                if slots and all('sharding' in sh.axes()
                                 for sh in slots.values()):
                    self._zero[name] = group

    def _local_batch(self, a):
        """This rank's block of a global input or label."""
        if self._batch_sharding is None or not torch.is_tensor(a) or \
                a.dim() == 0:
            return a
        layouts = None
        st = self._sp_state
        if st is not None and st['mode'] == 'zigzag' and a.dim() > 1:
            from ..distributed import sp as sp_mod
            from ..distributed.topology import mesh_axis_size
            p = mesh_axis_size(st['mesh'], st['axis'])
            if a.shape[1] % (2 * p) == 0:
                st['layout'] = 'zigzag'
                layouts = {1: lambda t, i, n: sp_mod.zigzag_chunks(t, 1, i,
                                                                   n)}
            else:
                st['layout'] = 'contiguous'
        return self._batch_sharding.local(a, layouts)

    def _scope(self):
        stack = contextlib.ExitStack()
        if self._sp_state is not None:
            from ..distributed.sp import sp_scope
            stack.enter_context(sp_scope(self._sp_state))
        if self._fce_sharding is not None:
            from ..ops.fused_ce import logits_sharding
            stack.enter_context(logits_sharding(self._fce_sharding))
        if self._data_group is not None:
            from ..incubate.moe import token_scope
            stack.enter_context(token_scope(self._data_group))
        return stack

    # -- forward and backward ------------------------------------------------
    def _cast_for_step(self, inputs):
        """Swap the storage of every parameter (frozen ones too, as the JAX
        step casts all of them) and of the floating buffers for copies in
        the AMP dtype; returns the cast inputs and what to restore."""
        amp = self._amp_dtype
        swapped = []
        # FSDP2 casts its parameters itself (MixedPrecisionPolicy)
        params = [] if self._fsdp else self.model.parameters()
        for p in params:
            if p.is_floating_point():
                swapped.append((p, p.data,
                                'grad' if p.requires_grad else 'frozen'))
                p.data = p.data.to(amp)
        for b in self.model.buffers():
            if b.is_floating_point():
                swapped.append((b, b.data, 'buffer'))
                b.data = b.data.to(amp)
        inputs = tuple(a.to(amp) if torch.is_tensor(a) and
                       a.is_floating_point() else a for a in inputs)
        return inputs, swapped

    @staticmethod
    def _restore(swapped):
        """Put the stored dtypes back: a trainable parameter's grad is cast
        to it, a frozen one gets its own storage back, a buffer's new value
        is cast to it."""
        for t, keep, kind in swapped:
            if kind == 'buffer':
                t.data = t.data.to(keep.dtype)
                continue
            g, t.grad = t.grad, None
            t.data = keep
            if kind == 'grad' and g is not None:
                t.grad = g.to(keep.dtype)

    def _loss_and_grads(self, inputs, labels):
        """Forward and backward; the loss (f32 under AMP), detached."""
        swapped = []
        if self._amp_dtype is not None:
            inputs, swapped = self._cast_for_step(inputs)
        try:
            def compute(*args):
                out = self.model(*args[:len(inputs)])
                outs = out if isinstance(out, (list, tuple)) else (out,)
                loss = self.loss_fn(*outs, *args[len(inputs):])
                return loss.float() if self._amp_dtype is not None else loss

            with self._scope():
                if self._pp_state is not None:
                    from ..distributed.pipeline import run_schedule
                    loss, self.pp_stats = run_schedule(
                        self.model, self.loss_fn, inputs, labels,
                        self._pp_state, self.loss_scale
                        if self._loss_scaling else 1.0)
                    return loss.detach()
                if self._remat:
                    loss = checkpoint(compute, *inputs, *labels,
                                      use_reentrant=False)
                else:
                    loss = compute(*inputs, *labels)
                # differentiate the scaled loss so fp16 cotangents stay
                # above the fp16 underflow floor; report the raw loss
                (loss * self.loss_scale if self._loss_scaling
                 else loss).backward()
        finally:
            self._restore(swapped)
        return loss.detach()

    # -- the step ------------------------------------------------------------
    def _update_scale(self, finite):
        grown = self._ls_growth + 1 >= self._ls_growth_interval
        if finite:
            if grown:
                self.loss_scale = min(self.loss_scale * 2.0,
                                      _MAX_LOSS_SCALE)
            self._ls_growth = 0 if grown else self._ls_growth + 1
        else:
            self.loss_scale = max(self.loss_scale * 0.5, 1.0)
            self._ls_growth = 0

    def __call__(self, inputs, labels):
        """One step (one micro-step under gradient merge) on a batch;
        returns the loss (detached, f32 under AMP)."""
        if not isinstance(inputs, (list, tuple)):
            inputs = (inputs,)
        if not isinstance(labels, (list, tuple)):
            labels = (labels,)
        inputs = tuple(self._local_batch(a) for a in inputs)
        labels = tuple(self._local_batch(a) for a in labels)
        self.model.train()
        for _, p in self._params:
            p.grad = None
        loss = self._loss_and_grads(inputs, labels)
        # every trainable parameter is updated, as in the JAX step, where a
        # parameter the loss does not reach has a zero grad; from here on
        # a sharded parameter's grad is its local shard
        grads = [_local(p.grad) if p.grad is not None
                 else torch.zeros_like(_local(p)) for _, p in self._params]
        for _, p in self._params:
            p.grad = None
        if self._grad_group is not None:
            self._average(grads, self._grad_group)
        if self._data_group is not None:
            loss = self._average([loss.clone()], self._data_group)[0]
        if self._grad_sync is not None:
            synced = self._grad_sync({name: g for (name, _), g in
                                      zip(self._params, grads)})
            grads = [synced[name] for name, _ in self._params]
        if self._loss_scaling:
            finite = unscale_and_check(grads, self.loss_scale)
            if self._mesh is not None:
                # every rank skips or applies alike
                flag = torch.tensor([0.0 if finite else 1.0],
                                    device=grads[0].device)
                dist.all_reduce(flag, op=dist.ReduceOp.MAX)
                finite = not bool(flag.item())
            self._update_scale(finite)
            if not finite:
                return loss
        if self._k_steps > 1:
            grads = self._merge(grads)
            if grads is None:
                return loss
        self._apply(grads)
        return loss

    @staticmethod
    @torch.no_grad()
    def _average(tensors, group):
        """Mean over the group's ranks, in place (one flat buffer a
        dtype); returns the tensors."""
        from torch._utils import (_flatten_dense_tensors,
                                  _unflatten_dense_tensors)
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group_ts in by_dtype.values():
            flat = _flatten_dense_tensors(group_ts)
            dist.all_reduce(flat, group=group.pg)
            flat.div_(group.nranks)
            torch._foreach_copy_(group_ts,
                                 _unflatten_dense_tensors(flat, group_ts))
        return tensors

    @torch.no_grad()
    def _merge(self, grads):
        """Add this micro-step's grads to the f32 sums; on the k-th, the
        grads to apply (the sums times 1 / k_steps under grad_merge_avg)
        and the sums zeroed, else None."""
        if self._acc is None:
            self._acc = [torch.zeros(g.shape, device=g.device,
                                     dtype=torch.float32
                                     if _is_low_precision(g) else g.dtype)
                         for g in grads]
        torch._foreach_add_(self._acc, [g.to(a.dtype) for g, a in
                                        zip(grads, self._acc)])
        self._micro += 1
        if self._micro < self._k_steps:
            return None
        scale = 1.0 / self._k_steps if self._grad_merge_avg else 1.0
        eff = torch._foreach_mul(self._acc, scale)
        torch._foreach_zero_(self._acc)
        self._micro = 0
        return eff

    def _apply(self, grads):
        opt = self.optimizer
        t = opt._step_count + 1
        pp = self._pp_norm_line()
        if not self._zero and pp is None and not any(
                _is_dtensor(p) for _, p in self._params):
            named = [(opt._name_for(p, name), p, g)
                     for (name, p), g in zip(self._params, grads)]
            opt._update(named, opt.get_lr(), t, lr_is_f32=True)
            opt._step_count = t
            return
        # sharded parameters or pipeline stages: clip over the global
        # norm, then update the local shards (ZeRO-1 / 2: this rank's
        # rows, then gathered)
        from ..optimizer.optimizers import Lamb, LarsMomentum
        if isinstance(opt, (Lamb, LarsMomentum)) and (self._zero or any(
                _shard_group(p) is not None for _, p in self._params)):
            raise NotImplementedError(
                '%s over sharded parameters is not ported yet: its trust '
                'ratio needs each parameter\'s whole norm (ROADMAP Queue 1 '
                'item 3, per-tensor norms under sharding)'
                % type(opt).__name__)
        clip, opt._grad_clip = opt._grad_clip, None
        try:
            if clip is not None:
                grads = self._clip_sharded(clip, grads, pp)
            named = []
            for (name, p), g in zip(self._params, grads):
                handle, g = self._handle(name, p, g)
                named.append((opt._name_for(p, name), handle, g))
            opt._update(named, opt.get_lr(), t, lr_is_f32=True)
        finally:
            opt._grad_clip = clip
        opt._step_count = t
        for name, p in self._params:
            if name in self._zero:
                self._gather_rows(name, p)

    def _handle(self, name, p, g):
        """The tensor the optimizer updates for p (keyed by its identity
        across steps, carrying p's metadata) and its grad. The handle's
        slots are the local part of p's: slots found under p itself (set
        before the first step) are sliced to it, and the optimizer's
        state_dict / set_state_dict reach them through a _ShardView."""
        group = self._zero.get(name)
        base = _local(p) if _is_dtensor(p) else p.data
        cached = self._handles.get(name)
        if cached is None or cached[0] != base.data_ptr():
            if group is not None:
                rows = base.shape[0] // group.nranks
                handle = base.narrow(0, group.rank * rows, rows)
            else:
                handle = base if _is_dtensor(p) else p
            if handle is not p:
                for key in _PARAM_META:
                    if hasattr(p, key):
                        setattr(handle, key, getattr(p, key))
                self._adopt_slots(p, handle, group)
            cached = (base.data_ptr(), handle)
            self._handles[name] = cached
        if group is not None:
            rows = g.shape[0] // group.nranks
            g = g.narrow(0, group.rank * rows, rows)
        return cached[1], g

    def _adopt_slots(self, p, handle, group):
        """Move p's optimizer slots onto its new handle: a previous
        handle's as they are, p's own (global) ones sliced."""
        opt = self.optimizer
        view = _ShardView(p, handle, group)
        old = opt._slot_views.get(id(p))
        slots = opt._slots.pop(id(old.local), None) if old else None
        if slots is None and id(p) in opt._slots:
            slots = {k: view.scatter(v)
                     for k, v in opt._slots.pop(id(p)).items()}
        if slots is not None:
            opt._slots[id(handle)] = slots
        opt._slot_views[id(p)] = view

    @torch.no_grad()
    def _gather_rows(self, name, p):
        group = self._zero[name]
        full = p.data
        parts = list(full.chunk(group.nranks, dim=0))
        dist.all_gather(parts, self._handles[name][1].clone(),
                        group=group.pg)

    def _pp_norm_line(self):
        """Under a pipeline of more than one stage whose optimizer clips
        by the global norm: (the 'pp' line's ProcessGroup, the ids of the
        shared weights this rank leaves out of the norm). Every stage that
        uses a tied weight holds its summed grad, and only the first rank
        of its tied group counts it. Else None."""
        from ..nn.clip import ClipGradByGlobalNorm
        state = self._pp_state
        if state is None or state['n_stages'] == 1 or not isinstance(
                self.optimizer._grad_clip, ClipGradByGlobalNorm):
            return None
        me = dist.get_rank()
        skip = {id(getattr(m, a)) for m, a, group in
                getattr(self.model, '_pp_tied', None) or []
                if group.ranks[0] != me}
        return state['mesh'].get_group(state['axis']), skip

    def _clip_sharded(self, clip, grads, pp=None):
        """The clip over sharded grads: ClipGradByGlobalNorm with the
        global norm (each shard group's squares summed over its ranks, and
        the sum over the pipeline's stages when `pp` is
        _pp_norm_line()'s), ClipGradByValue elementwise."""
        from ..nn.clip import ClipGradByGlobalNorm, ClipGradByValue
        if isinstance(clip, ClipGradByValue):
            return [g.clamp(clip.min, clip.max) for g in grads]
        if not isinstance(clip, ClipGradByGlobalNorm):
            raise NotImplementedError(
                '%s over sharded parameters is not ported yet (ROADMAP '
                'Queue 1 item 3, per-tensor clips under sharding)'
                % type(clip).__name__)
        pp_pg, skip = pp if pp is not None else (None, ())
        sums = {}
        for (_, p), g in zip(self._params, grads):
            if getattr(p, 'need_clip', True) and id(p) not in skip:
                pg = _shard_group(p)
                sq = g.float().square().sum()
                sums[pg] = sq if pg not in sums else sums[pg] + sq
        total = None
        for pg, sq in sums.items():
            if pg is not None:
                dist.all_reduce(sq, group=pg)
            total = sq if total is None else total + sq
        if pp_pg is not None:
            if total is None:  # a stage with nothing to clip
                total = torch.zeros((), device=grads[0].device if grads
                                    else 'cuda' if dist.get_backend(pp_pg)
                                    == 'nccl' else 'cpu')
            dist.all_reduce(total, group=pp_pg)
        if total is None:
            return grads
        norm = total.sqrt()
        scale = norm.new_tensor(clip.clip_norm) / norm.clamp_min(
            clip.clip_norm)
        return [(g.float() * scale).to(g.dtype)
                if getattr(p, 'need_clip', True) else g
                for (_, p), g in zip(self._params, grads)]

    def multi_step(self, inputs, labels):
        """K steps at one learning rate: every input and label carries a
        leading K axis. The JAX package runs them as one lax.scan program;
        here they are K eager steps. Returns the K losses."""
        if not isinstance(inputs, (list, tuple)):
            inputs = (inputs,)
        if not isinstance(labels, (list, tuple)):
            labels = (labels,)
        k = inputs[0].shape[0]
        return torch.stack([self([a[i] for a in inputs],
                                 [b[i] for b in labels]) for i in range(k)])

    def _no_program(self, *args, **kwargs):
        raise NotImplementedError(
            'the port builds no XLA program: its TrainStep runs eagerly, '
            'so there is no jaxpr, executable or HLO to return')

    trace_jaxpr = compiled_executable = compiled_hlo = _no_program
