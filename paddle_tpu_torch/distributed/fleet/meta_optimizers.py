"""Meta-optimizer strategies as explicit-communication steps (counterpart of
paddle_tpu/distributed/fleet/meta_optimizers.py; reference:
fleet/meta_optimizers/{localsgd,dgc,fp16_allreduce,gradient_merge,lars,
lamb}_optimizer.py).

The reference rewrites the static program to change what is communicated
and when; the JAX package runs its data-parallel step inside shard_map
over 'dp' with explicit psum / pmean. The port's ranks are processes, so
the collectives are torch.distributed calls over the dp group:

  - plain DDP        : grads <- mean over the ranks every step
  - fp16_allreduce   : grads cast to bf16 for the all-reduce, back after
  - dgc              : top-k sparsified grads (momentum correction + error
                       feedback, Lin et al.) summed instead of dense grads
  - localsgd         : no grad sync; the replicas diverge and the
                       parameters (and slots) are averaged every k_steps
  - gradient merge   : k micro-grads accumulated locally, synced and
                       applied on the k-th (composes with the modes above)

Each rank's model is its replica (the JAX engine stacks the replicas on a
leading 'dp' axis); the global batch is split over the ranks on dim 0.
The update is the optimizer's rule alone (`_apply`), at one learning rate,
as in the JAX engine: no clip, no decay, no regularizer. lars / lamb swap
the optimizer (select_optimizer).
"""
import torch
import torch.distributed as dist

__all__ = ['ShardMapDPStep', 'dgc_compress', 'select_optimizer']


def dgc_compress(g, momentum_buf, error_buf, momentum, sparsity):
    """Deep Gradient Compression (local side): momentum correction +
    error-feedback accumulation + top-k selection.

    Returns (dense_send, new_momentum, new_error): dense_send is the
    sparsified tensor (zeros off the top-k support) to be summed across
    ranks; the residual stays in error_buf.

    Reference: operators/dgc_op.cc + sparse_all_reduce_op_handle.cc.
    """
    u = momentum * momentum_buf + g          # momentum correction
    v = error_buf + u                        # error feedback accumulation
    flat = v.reshape(-1)
    k = max(int(flat.numel() * (1.0 - sparsity)), 1)
    thresh = torch.topk(flat.abs(), k).values[-1]
    mask = (v.abs() >= thresh).to(v.dtype)
    send = v * mask
    # masked-out residual carries over; masked-in entries reset
    new_error = v * (1 - mask)
    new_momentum = u * (1 - mask)
    return send, new_momentum, new_error


def select_optimizer(optimizer, strategy):
    """lars/lamb meta-optimizers: swap the inner optimizer when the
    strategy flag is set (reference lars_optimizer.py/lamb_optimizer.py
    _can_apply over Momentum/Adam)."""
    from ... import optimizer as opt_mod
    if strategy is None:
        return optimizer
    params = optimizer._parameter_list
    if params is not None:
        params = [(optimizer._names[id(p)], p)
                  if id(p) in optimizer._explicit_names else p
                  for p in params]
    if getattr(strategy, 'lamb', False) and \
            not isinstance(optimizer, opt_mod.Lamb):
        cfg = strategy.lamb_configs
        return opt_mod.Lamb(
            learning_rate=optimizer._lr,
            lamb_weight_decay=cfg.get('lamb_weight_decay', 0.01),
            parameters=params, grad_clip=optimizer._grad_clip)
    if getattr(strategy, 'lars', False) and \
            not isinstance(optimizer, opt_mod.LarsMomentum):
        cfg = strategy.lars_configs
        return opt_mod.LarsMomentum(
            learning_rate=optimizer._lr,
            momentum=getattr(optimizer, '_momentum', 0.9),
            lars_coeff=cfg.get('lars_coeff', 0.001),
            lars_weight_decay=cfg.get('lars_weight_decay', 0.0005),
            exclude_from_weight_decay=cfg.get('exclude_from_weight_decay',
                                              ()),
            epsilon=cfg.get('epsilon', 0.0),
            parameters=params, grad_clip=optimizer._grad_clip)
    return optimizer


class ShardMapDPStep:
    """Explicit-collective data-parallel training step (see module doc).

    Restrictions (as the JAX engine's): pure data parallelism over the
    group, uniform lr across params, no grad-clip hook, and buffers (e.g.
    BN stats) are not synced. In 'local' mode the replicas legitimately
    differ between parameter syncs. `mesh` is a DeviceMesh whose `axis`
    is the data-parallel group (every rank of a pure dp mesh)."""

    # DGC warm-up ladder (Lin et al. §3.3): dense before rampup_begin_step,
    # then increasingly sparse over rampup_step applied steps
    DGC_RAMP = (0.75, 0.9375, 0.984, 0.996)

    def __init__(self, model, loss_fn, optimizer, mesh=None, axis='dp',
                 mode='dense', k_steps=1, gm_k_steps=1, momentum=0.9,
                 sparsity=0.999, dtype_comm=torch.bfloat16, adaptive=False,
                 rampup_begin_step=0, rampup_step=1):
        assert mode in ('dense', 'fp16', 'dgc', 'local')
        from ..topology import flat_group
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.axis = axis
        self.mode = mode
        self.k_steps = max(int(k_steps), 1)      # localsgd param-sync period
        self.gm_k = max(int(gm_k_steps), 1)      # gradient-merge period
        self.momentum = momentum
        self.sparsity = sparsity
        self.dtype_comm = dtype_comm
        self.adaptive = adaptive
        self._adapt_last_loss = None
        self.rampup_begin_step = int(rampup_begin_step)
        self.rampup_step = max(int(rampup_step), 1)
        if mesh is None:
            from ..topology import default_mesh
            mesh = default_mesh(axis)
        self.mesh = mesh
        names = mesh.mesh_dim_names or ()
        axes = (axis,) if axis in names else tuple(names)
        self.group = flat_group(mesh, axes)
        self.n_dev = self.group.nranks
        self._params = [(name, p) for name, p in model.named_parameters()
                        if p.requires_grad]
        self._micro = 0          # micro-batch counter
        self._step = 0           # applied-step counter
        self._dgc_u = self._dgc_v = self._acc = None

    # -- collectives over the dp group --------------------------------------
    def _mean(self, tensors):
        for t in tensors:
            if self.n_dev > 1:
                dist.all_reduce(t, group=self.group.pg)
            t.div_(self.n_dev)
        return tensors

    def _local(self, a):
        if not torch.is_tensor(a) or a.dim() == 0 or self.n_dev == 1:
            return a
        rows = a.shape[0] // self.n_dev
        return a[self.group.rank * rows:(self.group.rank + 1) * rows]

    def __call__(self, inputs, labels):
        if not isinstance(inputs, (list, tuple)):
            inputs = (inputs,)
        if not isinstance(labels, (list, tuple)):
            labels = (labels,)
        inputs = tuple(self._local(a) for a in inputs)
        labels = tuple(self._local(a) for a in labels)
        self._micro += 1
        apply_opt = (self._micro % self.gm_k) == 0
        will_step = self._step + (1 if apply_opt else 0)
        sync_params = (self.mode == 'local' and apply_opt
                       and (will_step % self.k_steps) == 0)
        sparsity = self._current_sparsity() if self.mode == 'dgc' else None

        self.model.train()
        for _, p in self._params:
            p.grad = None
        out = self.model(*inputs)
        outs = out if isinstance(out, (list, tuple)) else (out,)
        loss = self.loss_fn(*outs, *labels)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for _, p in self._params]
        for _, p in self._params:
            p.grad = None
        loss = self._mean([loss.detach().clone()])[0]
        with torch.no_grad():
            self._communicate(grads, apply_opt, sync_params, sparsity,
                              will_step)
        if apply_opt:
            self._step = will_step
            self.optimizer._step_count = self._step
        if self.adaptive and sync_params:
            # adaptive localsgd: longer local phases while the synced loss
            # improves, shorter when it regresses
            cur = float(loss)
            if self._adapt_last_loss is not None:
                if cur < self._adapt_last_loss:
                    self.k_steps = min(self.k_steps * 2, 16)
                else:
                    self.k_steps = max(self.k_steps // 2, 1)
            self._adapt_last_loss = cur
        return loss

    def _communicate(self, grads, apply_opt, sync_params, sparsity, t):
        # gradient merge: accumulate locally, only the k-th applies
        if self.gm_k > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(g) for g in grads]
            grads = [a + g for a, g in zip(self._acc, grads)]
            if not apply_opt:
                self._acc = grads
                return
            grads = [g / self.gm_k for g in grads]
            self._acc = [torch.zeros_like(g) for g in grads]

        # --- communication (explicit) -----------------------------------
        if self.mode == 'dense':
            grads = self._mean(grads)
        elif self.mode == 'fp16':
            grads = [c.to(g.dtype) for c, g in zip(
                self._mean([g.to(self.dtype_comm) for g in grads]), grads)]
        elif self.mode == 'dgc':
            if sparsity is None:
                # warm-up phase: dense all-reduce, buffers untouched
                grads = self._mean(grads)
            else:
                if self._dgc_u is None:
                    self._dgc_u = [torch.zeros_like(g) for g in grads]
                    self._dgc_v = [torch.zeros_like(g) for g in grads]
                sends = []
                for i, g in enumerate(grads):
                    send, u, v = dgc_compress(g, self._dgc_u[i],
                                              self._dgc_v[i], self.momentum,
                                              sparsity)
                    sends.append(send)
                    self._dgc_u[i], self._dgc_v[i] = u, v
                grads = self._mean(sends)
        # mode == 'local': no grad communication at all

        if apply_opt:
            opt = self.optimizer
            lr = opt.get_lr()
            slots = []
            for (name, p), g in zip(self._params, grads):
                s = opt._get_slots(p)
                opt._apply_group = opt._group_key(name)
                new = opt._apply([p.data], [g.to(p.dtype)], [s], lr, t,
                                 True)[0]
                p.data.copy_(new.to(p.dtype))
                slots.append(s)
            if sync_params:
                # localsgd periodic model averaging
                self._mean([p.data for _, p in self._params])
                for s in slots:
                    self._mean(list(s.values()))

    def _current_sparsity(self):
        """DGC warm-up: None (dense) before rampup_begin_step, then climb
        the ramp ladder over rampup_step applied steps, ending at the
        target sparsity."""
        applied = self._step
        if applied < self.rampup_begin_step:
            return None
        if self.rampup_step <= 1:
            return self.sparsity
        ladder = [s for s in self.DGC_RAMP if s < self.sparsity] + \
            [self.sparsity]
        seg = self.rampup_step / float(len(ladder))
        idx = min(int((applied - self.rampup_begin_step) / seg),
                  len(ladder) - 1)
        return ladder[idx]
