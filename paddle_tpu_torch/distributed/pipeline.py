"""Pipeline-parallel engine (counterpart of paddle_tpu/distributed/
pipeline.py; reference: framework/section_worker.cc:104 micro-batch loop,
fleet/meta_parallel/pipeline_parallel.py:109 train_batch, pp_layers.py:76
stage partition).

The JAX package's schedule is one program: a lax.scan inside a shard_map
over 'pp' that rotates activations with ppermute. Here every rank is one
stage and runs its own loop over torch.distributed point-to-point calls to
its neighbours on the 'pp' line (NCCL on the card, gloo on the CPU):

  GPipe (this module)  every microbatch's forward, each activation sent to
                       the next stage; then the backwards in reverse, each
                       activation gradient sent to the previous stage;
                       then one update (TrainStep).
  1F1B (pipeline_1f1b.py) the same pieces, forwards and backwards
                       interleaved.

A received activation is a leaf that requires grad; a stage's backward is
torch.autograd.backward(out, grad_from_next), and the leaf's grad goes to
the previous stage. The loss of each microbatch is taken inside the last
stage and differentiated at 1 / n_micro of it (the step's loss is the
mean over the batch); the loss is broadcast from the last stage to its
line. Sends of 16-bit tensors between CPU ranks travel as f32 (gloo's
point-to-point; the JAX package's own rule for its CPU mesh).

Where the stages come from: a model with pp_decompose() (the GPT) gives
(pre, blocks, post); stage r runs pre on the first stage, blocks
[r*ceil(n/pp), min(n, (r+1)*ceil(n/pp))) (the JAX package pads the stack
with identity ghost layers to the same split) and post, which takes the
loss, on the last. A PipelineLayer is its own stage. On a pipeline of
more than one stage, keep_stage() drops the other stages' layers from
the model (TrainStep calls it), so each rank stores only its own.
Weights two stages use (the GPT's tied embedding, a SharedLayerDesc)
have their grads summed over those stages after the schedule.

The JAX GPipe keeps the embeddings and the head replicated over 'pp' and
runs them outside the pipelined region; the port runs them on the first
and the last stage: the same function. The JAX package pins its region
boundaries' shardings through its auto-parallel plan
(ap_tuner.resolve_plan_for_state); a rank-per-stage loop has no GSPMD
layout to pin, so nothing here corresponds to it.
"""
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

__all__ = ['PipelineEngine', 'make_pp_state', 'pp_scope', 'pipeline_state',
           'pipeline_blocks', 'stage_bounds', 'keep_stage', 'run_schedule']

_STATE = {'active': None}


def make_pp_state(mesh, n_stages, n_micro=None, axis='pp', remat=False,
                  schedule='gpipe'):
    """Build (without activating) a pipeline routing state, as the JAX
    package's: n_micro defaults to n_stages for GPipe and 2 * n_stages
    for 1F1B; remat checkpoints each layer of a stage; schedule 'gpipe'
    ('F-then-B' is GPipe) or '1f1b'. mesh may be None for one stage."""
    schedule = schedule.lower().replace('-', '')
    if schedule not in ('gpipe', '1f1b', 'fthenb'):
        raise ValueError('unknown pipeline schedule %r' % schedule)
    if schedule == 'fthenb':
        schedule = 'gpipe'
    default_micro = 2 * n_stages if schedule == '1f1b' else n_stages
    return {'mesh': mesh, 'axis': axis, 'n_stages': int(n_stages),
            'n_micro': int(n_micro or default_micro), 'remat': bool(remat),
            'schedule': schedule}


def pipeline_state():
    return _STATE['active']


class pp_scope:
    """Activate a pp state only around a step."""

    def __init__(self, state):
        self._state = state

    def __enter__(self):
        self._saved = _STATE['active']
        if self._state is not None:
            _STATE['active'] = self._state
        return self

    def __exit__(self, *exc):
        _STATE['active'] = self._saved
        return False


def stage_bounds(n_layers, n_stages, stage):
    """[lo, hi) of the layers stage `stage` holds: ceil(n / pp) a stage,
    the last stages holding fewer (or none) when pp does not divide n."""
    per = -(-n_layers // n_stages)
    return min(n_layers, stage * per), min(n_layers, (stage + 1) * per)


def pipeline_blocks(blocks, x, state=None):
    """A stage's blocks applied to x in order, each checkpointed
    (torch.utils.checkpoint, non-reentrant: its forward runs again in the
    backward) when the state asks for remat."""
    remat = bool(state and state.get('remat')) and torch.is_grad_enabled()
    for block in blocks:
        x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
    return x


def keep_stage(model, state, optimizer=None):
    """Drop from `model` (and from `optimizer`'s parameter list) the
    layers of the other stages of a pipeline of more than one stage,
    through the model's pp_keep_stage(stage, n_stages), which returns the
    (module, attribute) of the weights its first and last stage share;
    their group is made here. Done once a model; a PipelineLayer holds
    its own stage already."""
    n = state['n_stages']
    if n == 1 or getattr(model, '_pp_kept', None) is not None:
        return
    from .topology import pp_line, stage_group
    line = pp_line(state['mesh'], state['axis'])
    if line.n_stages != n:
        raise ValueError('pp state of %d stages on a %r axis of %d ranks'
                         % (n, state['axis'], line.n_stages))
    if hasattr(model, 'pp_keep_stage'):
        before = {id(p) for p in model.parameters()}
        shared = model.pp_keep_stage(line.stage, n)
        group = stage_group(state['mesh'], (0, n - 1), state['axis'])
        model._pp_tied = [(m, a, group) for m, a in shared
                          if group is not None]
        kept = {id(p) for p in model.parameters()}
        plist = getattr(optimizer, '_parameter_list', None)
        if plist is not None:
            optimizer._parameter_list = [
                p for p in plist if id(p) in kept or id(p) not in before]
    model._pp_kept = line.stage


def _pipeline_layer(model):
    from .meta_parallel.pp_layers import PipelineLayer
    inner = getattr(model, '_layers', model)
    return inner if isinstance(inner, PipelineLayer) else None


class _Stage:
    """What this rank runs for one microbatch: pre (first stage), its
    blocks, post and the loss (last stage)."""

    def __init__(self, model, loss_fn, state, line):
        self.first = line.stage == 0
        self.last = line.stage == line.n_stages - 1
        self.state = state
        if hasattr(model, 'pp_decompose'):
            pre, blocks, post = model.pp_decompose(loss_fn)
            blocks = list(blocks)
            if getattr(model, '_pp_kept', None) is None:
                lo, hi = stage_bounds(len(blocks), line.n_stages, line.stage)
                blocks = blocks[lo:hi]
            self.pre, self.blocks, self.post = pre, blocks, post
        elif _pipeline_layer(model) is not None or line.n_stages == 1:
            # a PipelineLayer is its stage's blocks; any other model on
            # one stage is its pre
            staged = _pipeline_layer(model) is not None
            self.pre = (lambda *inputs: inputs[0]) if staged else model
            self.blocks = [model] if staged else []

            def post(out, *labels):
                outs = out if isinstance(out, (list, tuple)) else (out,)
                return loss_fn(*outs, *labels)
            self.post = post
        else:
            raise ValueError(
                'a %d-stage pipeline needs the model\'s pp_decompose() or '
                'a PipelineLayer; %s has neither'
                % (line.n_stages, type(model).__name__))

    def __call__(self, x, inputs, labels):
        if self.first:
            x = self.pre(*inputs)
        x = pipeline_blocks(self.blocks, x, self.state)
        if self.last:
            return self.post(x, *labels)
        return x


_DTYPES = (torch.float32, torch.float16, torch.bfloat16, torch.float64)


class _Wire:
    """Point-to-point transfers to this rank's pipeline neighbours; every
    exchange is one batch_isend_irecv (sends and receives paired, so the
    1F1B steady state cannot deadlock). The first activation of a step
    is preceded by a header of its shape and dtype."""

    def __init__(self, line, device):
        self.line = line
        self.device = device
        self.meta = None      # (shape, dtype) of the activation received

    def _wire(self, t):
        t = t.detach().contiguous()
        if t.device.type == 'cpu' and t.dtype in (torch.float16,
                                                  torch.bfloat16):
            t = t.float()
        return t

    def _wire_dtype(self, dtype):
        return torch.float32 if self.device.type == 'cpu' and dtype in (
            torch.float16, torch.bfloat16) else dtype

    def exchange(self, send_next=None, send_prev=None, recv_prev=False,
                 recv_next=None):
        """Send to the next / previous stage and receive from them, as one
        batch. recv_next is the (shape, dtype) of the gradient expected
        back from the next stage. Returns (from_prev, from_next)."""
        ops, got_prev, got_next = [], None, None
        if send_next is not None:
            ops.append(dist.P2POp(dist.isend, self._wire(send_next),
                                  self.line.next))
        if send_prev is not None:
            ops.append(dist.P2POp(dist.isend, self._wire(send_prev),
                                  self.line.prev))
        if recv_prev:
            shape, dtype = self.meta
            got_prev = torch.empty(shape, dtype=self._wire_dtype(dtype),
                                   device=self.device)
            ops.append(dist.P2POp(dist.irecv, got_prev, self.line.prev))
        if recv_next is not None:
            shape, dtype = recv_next
            got_next = torch.empty(shape, dtype=self._wire_dtype(dtype),
                                   device=self.device)
            ops.append(dist.P2POp(dist.irecv, got_next, self.line.next))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        if got_prev is not None:
            got_prev = got_prev.to(self.meta[1])
        if got_next is not None:
            got_next = got_next.to(recv_next[1])
        return got_prev, got_next

    def send_header(self, y):
        head = torch.zeros(8, dtype=torch.long, device=self.device)
        head[0] = y.dim()
        head[1] = _DTYPES.index(y.dtype)
        head[2:2 + y.dim()] = torch.tensor(y.shape)
        for work in dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, head, self.line.next)]):
            work.wait()

    def recv_header(self):
        head = torch.zeros(8, dtype=torch.long, device=self.device)
        for work in dist.batch_isend_irecv(
                [dist.P2POp(dist.irecv, head, self.line.prev)]):
            work.wait()
        h = head.tolist()
        self.meta = (tuple(h[2:2 + h[0]]), _DTYPES[h[1]])


_LOW = (torch.float16, torch.bfloat16)
_WARM = []


class _Run:
    """One step's microbatches on this rank: F(i) runs microbatch i's
    forward from the received activation (or the inputs) and stashes its
    graph; B(i) runs its backward. `peak` is the most microbatches whose
    graphs were held at once. The grads of 16-bit parameters are summed
    over the microbatches in f32 (as TrainStep's gradient merge sums
    them), and handed back in the parameter's dtype by finish()."""

    def __init__(self, stage, wire, inputs, labels, n_micro, loss_scale,
                 params):
        self.stage = stage
        self.wire = wire
        self.inputs = inputs
        self.labels = labels
        self.n_micro = n_micro
        self.scale = loss_scale / n_micro
        self.stash = {}
        self.peak = 0
        self.losses = []
        self.sent_header = False
        self.low = [p for p in params if p.requires_grad and
                    p.dtype in _LOW] if n_micro > 1 else []
        self.acc = {}

    def forward(self, i, x):
        """The activation to send on (None on the last stage)."""
        ins = [t[i] for t in self.inputs]
        lbls = [t[i] for t in self.labels]
        out = self.stage(x, ins, lbls)
        if self.stage.last:
            loss = out.float()
            self.losses.append(loss.detach())
            self.stash[i] = (x, loss * self.scale, None)
            out = None
        else:
            self.stash[i] = (x, out, (out.shape, out.dtype))
        self.peak = max(self.peak, len(self.stash))
        return out

    def backward(self, i, grad):
        """The gradient of microbatch i's received activation (None on the
        first stage)."""
        x, out, _ = self.stash.pop(i)
        if grad is None:
            torch.autograd.backward(out)
        else:
            torch.autograd.backward(out, grad)
        with torch.no_grad():
            for p in self.low:
                if p.grad is not None:
                    g, p.grad = p.grad.float(), None
                    acc = self.acc.get(id(p))
                    self.acc[id(p)] = g if acc is None else acc.add_(g)
        if x is None:
            return None
        return x.grad if x.grad is not None else torch.zeros_like(x)

    def finish(self):
        for p in self.low:
            acc = self.acc.get(id(p))
            if acc is not None:
                p.grad = acc.to(p.dtype)
        self.acc = {}

    def grad_meta(self, i):
        return self.stash[i][2]

    def recv_forward(self):
        if self.stage.first:
            return None
        if self.wire.meta is None:
            self.wire.recv_header()
        x, _ = self.wire.exchange(recv_prev=True)
        return x.requires_grad_()

    def send_forward(self, y):
        if y is None:
            return
        if not self.sent_header:
            self.wire.send_header(y)
            self.sent_header = True
        self.wire.exchange(send_next=y)


def _gpipe(run, n_micro):
    for i in range(n_micro):
        run.send_forward(run.forward(i, run.recv_forward()))
    for i in reversed(range(n_micro)):
        grad = None
        if not run.stage.last:
            _, grad = run.wire.exchange(recv_next=run.grad_meta(i))
        dx = run.backward(i, grad)
        if not run.stage.first:
            run.wire.exchange(send_prev=dx)


def _split(t, n):
    if not torch.is_tensor(t) or t.dim() == 0:
        return [t] * n
    if t.shape[0] % n:
        raise ValueError('batch %d not divisible by n_micro=%d'
                         % (t.shape[0], n))
    return list(t.chunk(n))


def run_schedule(model, loss_fn, inputs, labels, state, loss_scale=1.0):
    """Forward and backward of one step under the pp state `state` on this
    rank: the grads accumulate on its parameters (the shared weights'
    summed over their stages). Returns (the step's loss, the mean of the
    microbatch losses, on every rank of the line; stats)."""
    from .pipeline_1f1b import one_f_one_b
    from .topology import pp_line
    n_micro = state['n_micro']
    line = pp_line(state['mesh'], state['axis'])
    if line.n_stages != state['n_stages']:
        raise ValueError('pp state of %d stages on a %r axis of %d ranks'
                         % (state['n_stages'], state['axis'],
                            line.n_stages))
    if line.n_stages > 1 and not _WARM:
        # the default group's first operation (its communicator's start,
        # on NCCL) as a collective of every rank, not a pair's send
        dist.barrier()
        _WARM.append(True)
    stage = _Stage(model, loss_fn, state, line)
    device = next((t.device for t in list(inputs) + list(labels)
                   if torch.is_tensor(t)), torch.device('cpu'))
    run = _Run(stage, _Wire(line, device),
               [_split(t, n_micro) for t in inputs],
               [_split(t, n_micro) for t in labels], n_micro, loss_scale,
               list(model.parameters()))
    with pp_scope(state):
        if state['schedule'] == '1f1b':
            one_f_one_b(run, n_micro, line)
        else:
            _gpipe(run, n_micro)
    run.finish()
    if run.losses:
        loss = torch.stack(run.losses).mean()
    else:
        loss = torch.zeros((), dtype=torch.float32, device=device)
    if line.n_stages > 1:
        pg = state['mesh'].get_group(state['axis'])
        dist.broadcast(loss, src=line.ranks[-1], group=pg)
        _sum_tied(model)
    stats = {'peak_stash': run.peak, 'n_micro': n_micro,
             'schedule': state['schedule'], 'stage': line.stage}
    return loss, stats


@torch.no_grad()
def _sum_tied(model):
    """Sum the grads of the weights two stages share over those stages."""
    from torch.distributed.tensor import DTensor
    for module, attr, group in getattr(model, '_pp_tied', None) or []:
        p = getattr(module, attr)
        g = p.grad
        if g is None:
            g = p.grad = torch.zeros_like(p)
        local = g._local_tensor if isinstance(g, DTensor) else g
        buf = local.float() if local.device.type == 'cpu' else local
        dist.all_reduce(buf, group=group.pg)
        if buf is not local:
            local.copy_(buf)


class PipelineEngine:
    """Executes PipelineLayer models: the microbatch split, the schedule,
    the grads and the optimizer update through one TrainStep (reference
    SectionWorker TrainFiles + PipelineParallel.train_batch)."""

    def __init__(self, pipeline_layer, optimizer, hcg, n_micro=None):
        self.layer = pipeline_layer
        self.optimizer = optimizer
        self.hcg = hcg
        pp = max(hcg.get_pipe_parallel_world_size(), 1)
        self.n_micro = n_micro or pp
        self._step = None
        self._pp_state = None
        if pp > 1:
            self._pp_state = make_pp_state(hcg.mesh, n_stages=pp,
                                           n_micro=self.n_micro)

    def _build(self):
        from ..framework import functional as func_mod
        model = self.layer
        loss_fn = model._loss_fn
        self._step = func_mod.TrainStep(model, loss_fn, self.optimizer,
                                        mesh=self.hcg.mesh,
                                        pp_state=self._pp_state)

    def step(self, inputs, labels):
        if self._step is None:
            self._build()
        return self._step(inputs, labels)
