"""paddle.static (counterpart of paddle_tpu/static/__init__.py; reference:
python/paddle/static/__init__.py).

The reference's static mode builds a ProgramDesc and runs it on the C++
Executor. Here, as in the JAX package, a Program is a recording: code
inside `program_guard` runs eagerly while framework/recorder.py records
its torch calls into the Program, and `Executor.run` replays the calls
that the fetches need from fresh feed values. The replay is an
fx.GraphModule compiled once per feed signature (jit.StaticFunction:
torch.compile with fullgraph, the hand-written kernels inside it as the
custom ops of ops/flash_attention.py); a compile failure raises.

Integer tensors reach the recorder as arguments like any other (the port's
functionals hand the ids to torch), so a Program fed with token ids
replays them: fresh ids give fresh fetches.

save_inference_model writes a torch.export program of the replay with the
weights inside it, in the place of the JAX package's jax.export blob;
load_inference_model also serves reference-format model directories
(inference/fluid_program.py). The byte formats are the port's own.
"""
import io
import os
import pickle

import numpy as np
import torch

from ..framework import device as device_mod
from ..framework import dtype as dtype_mod
from ..framework import io_save, recorder
from .input_spec import InputSpec

__all__ = ['InputSpec', 'data', 'Program', 'Executor', 'default_main_program',
           'default_startup_program', 'program_guard', 'name_scope',
           'save', 'load', 'save_inference_model', 'load_inference_model',
           'accuracy', 'auc', 'Variable', 'Scope', 'global_scope', 'scope_guard',
           'create_global_var', 'create_parameter', 'append_backward',
           'gradients', 'Print', 'py_func', 'cuda_places', 'xpu_places',
           'WeightNormParamAttr', 'ParallelExecutor', 'serialize_program',
           'deserialize_program', 'serialize_persistables',
           'deserialize_persistables', 'save_to_file', 'load_from_file',
           'save_vars', 'load_vars', 'load_program_state',
           'set_program_state', 'normalize_program',
           'CompiledProgram', 'BuildStrategy', 'ExecutionStrategy', 'cpu_places',
           'device_guard', 'amp_guard']


# paddle.enable_static / disable_static: a flag, as in the JAX package.
# Programs are recordings made under program_guard in either mode.
_MODE = {'static': False}


def enable_static():
    _MODE['static'] = True


def disable_static(place=None):
    _MODE['static'] = False


def in_dynamic_mode():
    return not _MODE['static']


def _static_function(module):
    from ..jit import StaticFunction
    return StaticFunction(module.forward, layer=module)


def _to_numpy(t):
    """A fetch on the host; bf16 (which numpy lacks) as its f32 values."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _feed_tensor(value, dtype, device):
    t = value if isinstance(value, torch.Tensor) \
        else torch.as_tensor(np.asarray(value))
    return t.to(device=device, dtype=dtype)


class Program:
    """A recorded computation (the reference's ProgramDesc without the
    protobuf IR). Code inside `program_guard(program)` runs eagerly and
    records its torch calls here; Executor.run replays the ones its
    fetches need from new feed values."""

    def __init__(self):
        self._recording = recorder.Recording()
        self._feed_vars = {}
        self._fetch_cache = {}
        self._programs = {}
        self.random_seed = None

    @property
    def _ops(self):
        return self._recording.calls

    def add(self, func, args, kwargs, out):
        """The recorder's sink: one torch call."""
        self._recording.add(func, args, kwargs, out)
        self._programs.clear()

    def _replay(self, feeds, fetches, device):
        """The fetches recomputed from `feeds` ({name: tensor on device}),
        compiled once per feed signature."""
        names = sorted(feeds)
        key = (tuple(names), tuple(id(t) for t in fetches), str(device))
        program = self._programs.get(key)
        if program is None:
            gm = self._recording.graph_module(
                [self._feed_vars[n] for n in names], fetches, device)
            program = self._programs[key] = _static_function(gm)
        with torch.no_grad(), recorder.paused():
            return list(program(*[feeds[n] for n in names]))

    def program_count(self):
        """The signatures compiled so far."""
        return sum(p.program_count() for p in self._programs.values())

    def compile_count(self):
        """The graphs compiled so far, over every signature."""
        return sum(p.compile_count() for p in self._programs.values())

    def global_block(self):
        return self

    def clone(self, for_test=False):
        return self

    def all_parameters(self):
        return self._recording.parameters()

    def __repr__(self):
        return 'Program(%d recorded torch calls)' % len(self._ops)


_main_program = Program()
_startup_program = Program()


def default_main_program():
    return _main_program


def default_startup_program():
    return _startup_program


class program_guard:
    """Scope that routes static.data() and the recording of every torch
    call to `main_program` (reference: fluid/framework.py program_guard)."""

    def __init__(self, main_program, startup_program=None):
        self._main = main_program
        self._startup = startup_program

    def __enter__(self):
        global _main_program, _startup_program
        self._saved = (_main_program, _startup_program)
        _main_program = self._main
        if self._startup is not None:
            _startup_program = self._startup
        self._recording = recorder.recording(self._main)
        self._recording.__enter__()
        return self

    def __exit__(self, *exc):
        global _main_program, _startup_program
        self._recording.__exit__(*exc)
        _main_program, _startup_program = self._saved
        return False


class name_scope:
    def __init__(self, prefix=None):
        self.prefix = prefix

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class device_guard:
    def __init__(self, device=None):
        self.device = device

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def data(name, shape, dtype='float32', lod_level=0):
    """Declare a feed variable: a placeholder (zeros; None or -1 dims are
    1) on the current device, filled by Executor.run(feed=...)."""
    shp = tuple(1 if (s is None or s < 0) else s for s in shape)
    with recorder.paused():
        t = torch.zeros(shp, dtype=dtype_mod.torch_dtype(dtype),
                        device=device_mod.resolve())
    _main_program._feed_vars[name] = t
    return t


class Executor:
    """Runs Programs on `place` ('gpu', 'gpu:N', 'cpu' or a torch.device;
    None is the current device, the card unless set_device('cpu'))."""

    def __init__(self, place=None):
        self.place = place

    def _device(self):
        return device_mod.resolve(self.place)

    def run(self, program=None, feed=None, fetch_list=None,
            return_numpy=True, **kwargs):
        """The fetches from fresh feeds: numpy arrays, or with
        return_numpy=False tensors on the device."""
        program = program or _main_program
        if isinstance(program, CompiledProgram):
            program = program.program
        feed = feed or {}
        device = self._device()
        if isinstance(program, LoadedProgram):
            outs = program(feed, device)
            if fetch_list:
                outs = [outs[i] for i in fetch_list]
            return [_to_numpy(t) if return_numpy else t for t in outs]
        feeds = {}
        for name, value in feed.items():
            var = program._feed_vars.get(name)
            if var is None:
                raise KeyError(
                    'feed name %r is not a declared feed var of this '
                    'Program (declared: %s)'
                    % (name, sorted(program._feed_vars)))
            feeds[name] = _feed_tensor(value, var.dtype, device)
        fetches = []
        for f in (fetch_list or []):
            t = f if isinstance(f, torch.Tensor) \
                else program._fetch_cache.get(f)
            if t is None:
                raise KeyError('fetch target %r is neither a Tensor nor a '
                               'registered fetch name' % (f,))
            fetches.append(t)
        if feeds and program._ops:
            outs = program._replay(feeds, fetches, device)
        elif feeds:
            raise RuntimeError(
                'Executor.run got feeds but this Program recorded no ops — '
                'build the graph inside `with static.program_guard(program):`'
                ' so run() can replay it with fresh feed values (feeding a '
                'never-recorded program would silently return stale '
                'build-time values)')
        else:
            outs = fetches
        return [_to_numpy(t) if return_numpy else t for t in outs]

    def close(self):
        pass


class CompiledProgram:
    def __init__(self, program, build_strategy=None):
        self.program = program
        self.build_strategy = build_strategy

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None):
        return self


class BuildStrategy:
    """Compile-option surface (reference: details/build_strategy.h), kept
    as attributes; torch.compile decides the fusions."""

    def __init__(self):
        self.enable_inplace = True
        self.memory_optimize = True
        self.fuse_all_reduce_ops = True
        self.fuse_elewise_add_act_ops = True
        self.fuse_bn_act_ops = True
        self.reduce_ = 'AllReduce'
        self.gradient_scale_ = 'CoeffNumDevice'
        self.build_cinn_pass = False


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 10
        self.use_thread_barrier = False


def cpu_places(device_count=None):
    """CPU places (reference: CPU_NUM of them when device_count is None)."""
    n = device_count or int(os.environ.get('CPU_NUM', 1))
    return [torch.device('cpu')] * n


def accuracy(input, label, k=1, correct=None, total=None):
    """paddle.static.accuracy parity (operators/metrics/accuracy_op.cc)."""
    from ..metric import accuracy as _acc
    return _acc(input, label, k=k, correct=correct, total=total)


def auc(input, label, curve='ROC', num_thresholds=4095, topk=1,
        slide_steps=1):
    """paddle.static.auc parity (operators/metrics/auc_op.cc)."""
    from ..metric import auc as _auc
    out = _auc(input, label, curve=curve, num_thresholds=num_thresholds)
    return out, out, []


def amp_guard(*args, **kwargs):
    from ..amp import auto_cast
    return auto_cast(*args, **kwargs)


# -- save/load (reference: fluid/io.py:1840,1948 + save_inference_model) ----

def _param_key(p, i):
    return getattr(p, 'param_name', None) or 'param_%d' % i


def _program_state(program):
    return {_param_key(p, i): p
            for i, p in enumerate(program._recording.parameters())}


def save(program, model_path, protocol=4, **configs):
    """The program's parameters to `model_path.pdparams` (io_save) and a
    marker to `model_path.pdmodel`."""
    io_save.save({'program': 'static'}, model_path + '.pdmodel')
    io_save.save({k: p.detach() for k, p in _program_state(program).items()},
                 model_path + '.pdparams', protocol=protocol)


def load(program, model_path, executor=None, var_list=None):
    """Copy the parameters save() wrote back into the program's."""
    path = model_path + '.pdparams'
    if not os.path.exists(path):
        return
    state = io_save.load(path)
    with torch.no_grad():
        for key, p in _program_state(program).items():
            if key in state:
                p.copy_(state[key])


def _feed_names(program, feed_vars):
    name_of = {id(v): n for n, v in program._feed_vars.items()}
    names, tensors = [], []
    for i, v in enumerate(feed_vars):
        if isinstance(v, str):
            names.append(v)
            tensors.append(program._feed_vars[v])
        else:
            names.append(name_of.get(id(v), 'feed_%d' % i))
            tensors.append(v)
    return names, tensors


def _export_payload(program, feed_vars, fetch_vars):
    """The replay of feed_vars -> fetch_vars as a serialized torch.export
    program, the weights inside it, at the feeds' shapes."""
    if not program._ops:
        raise RuntimeError(
            'save_inference_model needs a recorded Program — build the '
            'graph inside `with static.program_guard(program):`')
    names, tensors = _feed_names(program, feed_vars)
    by_name = dict(zip(names, tensors))
    ordered = sorted(by_name)
    inputs = [by_name[n] for n in ordered]
    gm = program._recording.graph_module(inputs, list(fetch_vars))
    with torch.no_grad(), recorder.paused():
        exported = torch.export.export(gm, tuple(inputs), strict=False)
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return {'feed_names': ordered,
            'feed_dtypes': [str(t.dtype).split('.')[-1] for t in inputs],
            'exported': buf.getvalue(), 'n_fetch': len(fetch_vars)}


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor,
                         program=None, **kwargs):
    """feed -> fetch as a torch.export program with the weights inside it,
    in `path_prefix.pdmodel` (reference: fluid/io.py save_inference_model
    writing __model__ + params). The program must have been built inside
    a program_guard, as for Executor.run."""
    payload = _export_payload(program or _main_program, feed_vars,
                              fetch_vars)
    io_save.save(payload, path_prefix + '.pdmodel')


class LoadedProgram:
    """What load_inference_model returns as `program`: a deserialized
    torch.export program that Executor.run runs with fresh feeds, compiled
    once per feed signature on each device."""

    def __init__(self, feed_names, exported_blob, n_fetch, feed_dtypes=None):
        from ..ops import flash_attention  # noqa: F401 (the custom ops)
        self.feed_names = list(feed_names)
        self.n_fetch = n_fetch
        self._blob = exported_blob
        self._dtypes = [dtype_mod.torch_dtype(d) for d in feed_dtypes] \
            if feed_dtypes else [None] * len(self.feed_names)
        self._programs = {}

    @classmethod
    def _from_payload(cls, payload):
        return cls(payload['feed_names'], payload['exported'],
                   payload['n_fetch'], payload.get('feed_dtypes'))

    def _program(self, device):
        program = self._programs.get(str(device))
        if program is None:
            exported = torch.export.load(io.BytesIO(self._blob))
            tensors = list(exported.state_dict.values()) + \
                list(exported.constants.values())
            if any(isinstance(t, torch.Tensor) and
                   not recorder.same_device(t.device, device)
                   for t in tensors):
                from torch.export.passes import move_to_device_pass
                exported = move_to_device_pass(exported, device)
            program = self._programs[str(device)] = _static_function(
                exported.module())
        return program

    def __call__(self, feed, device=None):
        device = device_mod.resolve(device)
        args = [_feed_tensor(feed[n], d, device)
                for n, d in zip(self.feed_names, self._dtypes)]
        with torch.no_grad(), recorder.paused():
            return list(self._program(device)(*args))

    def program_count(self):
        return sum(p.program_count() for p in self._programs.values())

    def compile_count(self):
        return sum(p.compile_count() for p in self._programs.values())


class FluidLoadedProgram(LoadedProgram):
    """A reference-produced inference model (__model__ ProgramDesc +
    LoDTensor params, inference/fluid_program.py) served through the same
    Executor.run contract as the port's own artifacts — the fluid
    load_inference_model + executor path of the reference book tests
    (fluid/io.py load_inference_model; analysis_predictor.cc:201)."""

    def __init__(self, fluid_prog):
        self.feed_names = list(fluid_prog.feed_names)
        self.n_fetch = len(fluid_prog.fetch_names)
        self._fluid = fluid_prog

    def __call__(self, feed, device=None):
        return self._fluid.run(feed, return_numpy=False)

    def program_count(self):
        return self._fluid.program_count()

    def compile_count(self):
        return self._fluid.compile_count()


def _fluid_artifact_candidate(path_prefix, model_filename=None):
    """Path of a reference-format ProgramDesc under `path_prefix`, or
    None when path_prefix is one of the port's own artifact prefixes."""
    if os.path.isdir(path_prefix):
        if model_filename:
            return os.path.join(path_prefix, model_filename)
        if os.path.exists(os.path.join(path_prefix, '__model__')):
            return path_prefix
        if any(f.endswith('.pdmodel') for f in os.listdir(path_prefix)):
            return path_prefix
        return None
    if path_prefix.endswith('.pdmodel') or \
            os.path.basename(path_prefix) == '__model__':
        return path_prefix
    return None


def load_inference_model(path_prefix, executor, **kwargs):
    """Returns [program, feed_target_names, fetch_targets] (paddle order);
    run via exe.run(program, feed={...}, fetch_list=fetch_targets).

    Accepts both the port's save_inference_model artifacts (path prefix)
    and reference-produced model directories (__model__ / *.pdmodel +
    LoDTensor params; pass model_filename / params_filename for combined
    layouts, as in the reference API), loaded onto the executor's
    device."""
    model_filename = kwargs.get('model_filename')
    params_filename = kwargs.get('params_filename')
    cand = _fluid_artifact_candidate(path_prefix, model_filename)
    if cand is not None:
        from ..inference.fluid_program import load_fluid_model
        pp = params_filename
        if pp and os.path.isdir(path_prefix):
            pp = os.path.join(path_prefix, pp)
        device = executor._device() if executor is not None else None
        prog = FluidLoadedProgram(load_fluid_model(cand, pp, device=device))
        return [prog, list(prog.feed_names), list(range(prog.n_fetch))]
    prog = LoadedProgram._from_payload(io_save.load(path_prefix + '.pdmodel'))
    if executor is not None:
        prog._program(executor._device())  # deserialized onto the device
    return [prog, list(prog.feed_names), list(range(prog.n_fetch))]


from . import nn  # noqa: E402,F401
# -- fluid-era static surface (reference: python/paddle/static/__init__.py
# re-exports of fluid Executor-world APIs) ----------------------------------

Variable = torch.Tensor  # the reference's graph Variable: a recorded tensor


class Scope:
    """Name -> value store (reference framework/scope.h Scope facade)."""

    def __init__(self):
        self._vars = {}

    def var(self, name):
        if name not in self._vars:
            with recorder.paused():
                self._vars[name] = torch.zeros(
                    (), dtype=torch.float32, device=device_mod.resolve())
        return self._vars[name]

    def find_var(self, name):
        return self._vars.get(name)

    def local_scope(self):
        return Scope()


_global_scope = Scope()


def global_scope():
    return _global_scope


class scope_guard:
    def __init__(self, scope):
        self._scope = scope

    def __enter__(self):
        global _global_scope
        self._saved = _global_scope
        _global_scope = self._scope
        return self

    def __exit__(self, *exc):
        global _global_scope
        _global_scope = self._saved
        return False


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    device = 'cpu' if force_cpu else None
    t = torch.full(tuple(shape), value, dtype=dtype_mod.torch_dtype(dtype),
                   device=device_mod.resolve(device))
    t.persistable = persistable
    if name:
        _global_scope._vars[name] = t
    return t


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    from ..nn import initializer as init_mod
    from ..nn.layer.layers import create_parameter as _create
    init = default_initializer or (init_mod.Constant(0.0) if is_bias
                                   else init_mod.XavierNormal())
    p = _create(list(shape), attr, dtype_mod.convert_dtype(dtype), init,
                None, device_mod.resolve())
    if name:
        p.param_name = name
    return p


def _reachable_parameters(loss):
    """The nn.Parameters that `loss` reaches through its autograd graph,
    in the order a depth-first walk finds them. The walk holds every node
    it visited: a node's Python object may be made afresh on each access,
    so an id alone could be reused."""
    params, seen, visited = [], set(), {}
    stack = [loss.grad_fn] if loss.grad_fn is not None else []
    while stack:
        node = stack.pop()
        if id(node) in visited:
            continue
        visited[id(node)] = node
        for nxt, _ in node.next_functions:
            if nxt is None:
                continue
            var = getattr(nxt, 'variable', None)
            if isinstance(var, torch.nn.Parameter):
                if id(var) not in seen:
                    seen.add(id(var))
                    params.append(var)
            else:
                stack.append(nxt)
    return params


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """Reference fluid/backward.py:1369: the gradients of `loss`, as
    [(param, grad)] pairs. The parameters the loss reaches are found by
    walking its autograd graph; the backward then runs once (not recorded)
    and each pair holds the parameter's .grad."""
    params = _reachable_parameters(loss)
    with recorder.paused():
        loss.backward()
    pairs = [(p, p.grad) for p in params if p.grad is not None]
    if parameter_list:
        wanted = {id(p) for p in parameter_list}
        pairs = [pg for pg in pairs if id(pg[0]) in wanted]
    return pairs


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """Reference fluid/backward.py:1964: d(targets)/d(inputs) through
    autograd.grad."""
    from ..autograd import grad as _grad
    outs = _grad(targets, inputs, grad_outputs=target_gradients,
                 allow_unused=True)
    return list(outs) if isinstance(outs, (list, tuple)) else [outs]


@torch.library.custom_op('paddle_tpu_torch::print', mutates_args=())
def _print_op(x: torch.Tensor, message: str) -> torch.Tensor:
    """Print `message` and x's values, then pass x on (a copy: an op's
    output may not alias its input)."""
    print(message + ' ' + str(x), flush=True)
    return x.clone()


@_print_op.register_fake
def _print_fake(x, message):
    return torch.empty_like(x)


_print_op.register_autograd(lambda ctx, g: (g, None))


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_layout=True,
          print_tensor_lod=True, print_phase='both'):
    """Debug print op (reference operators/print_op): an op that prints
    each time it runs, eagerly, in a replay and inside a compiled program,
    and passes the value through."""
    return _print_op(input, message or '')


# py_func's callables, by the key its op carries; one key for each
# (func, outputs, backward_func), which the entry keeps alive
_PY_FUNCS = {}
_PY_FUNC_KEYS = {}


def _templates(key, which):
    return [torch.empty(s, dtype=d, device=dev)
            for s, d, dev in _PY_FUNCS[key][which]]


@torch.library.custom_op('paddle_tpu_torch::py_func', mutates_args=())
def _py_func_op(xs: list[torch.Tensor], key: int) -> list[torch.Tensor]:
    """Run the host callable registered under `key` on numpy copies of xs;
    its results come back as tensors of the registered outputs' shapes,
    dtypes and devices."""
    func = _PY_FUNCS[key][0]
    res = func(*[_to_numpy(x) for x in xs])
    res = list(res) if isinstance(res, (list, tuple)) else [res]
    return [torch.as_tensor(np.asarray(r)).to(dtype=t.dtype, device=t.device)
            .reshape(t.shape) for r, t in zip(res, _templates(key, 1))]


@_py_func_op.register_fake
def _py_func_fake(xs, key):
    return _templates(key, 1)


@torch.library.custom_op('paddle_tpu_torch::py_func_grad', mutates_args=())
def _py_func_grad_op(xs: list[torch.Tensor], grads: list[torch.Tensor],
                     key: int) -> list[torch.Tensor]:
    """backward_func(*inputs, *output_grads) -> the inputs' gradients."""
    backward_func = _PY_FUNCS[key][2]
    res = backward_func(*[_to_numpy(x) for x in list(xs) + list(grads)])
    res = list(res) if isinstance(res, (list, tuple)) else [res]
    return [torch.as_tensor(np.asarray(r)).to(dtype=x.dtype, device=x.device)
            .reshape(x.shape) for r, x in zip(res, xs)]


@_py_func_grad_op.register_fake
def _py_func_grad_fake(xs, grads, key):
    return [torch.empty_like(x) for x in xs]


def _py_func_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs[0])
    ctx.key = inputs[1]


def _py_func_backward(ctx, grads):
    return _py_func_grad_op(list(ctx.saved_tensors), list(grads),
                            ctx.key), None


_py_func_op.register_autograd(_py_func_backward, setup_context=_py_func_setup)


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """Reference operators/py_func_op: a host Python callable as an op (the
    custom op paddle_tpu_torch::py_func, in the place of the JAX package's
    pure_callback). `out` gives the result template(s).
    backward_func(*inputs, *output_grads) -> input grads gives the
    gradient; without it, gradient-requiring inputs raise (a host callback
    has no automatic derivative)."""
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    outs = out if isinstance(out, (list, tuple)) else [out]
    needs_grad = any(t.requires_grad for t in xs)
    if needs_grad and backward_func is None:
        raise ValueError(
            'py_func input requires grad but no backward_func was given — '
            'host callbacks have no automatic derivative (reference '
            'py_func_op needs one too)')
    spec = tuple((tuple(o.shape), o.dtype, o.device) for o in outs)
    key = _PY_FUNC_KEYS.setdefault((id(func), spec, id(backward_func)),
                                   len(_PY_FUNCS))
    _PY_FUNCS[key] = (func, spec, backward_func)
    res = _py_func_op(xs, key)
    return res[0] if len(res) == 1 else tuple(res)


def cuda_places(device_ids=None):
    """The CUDA devices (all visible ones when device_ids is None)."""
    if device_ids is None:
        device_ids = range(torch.cuda.device_count())
    return [torch.device('cuda', i) for i in device_ids]


def xpu_places(device_ids=None):
    return cuda_places(device_ids)


class WeightNormParamAttr:
    """Accepted for API parity; weight-norm reparameterization is not
    applied by the static builders."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 do_model_average=False, need_clip=True):
        self.dim = dim
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip


class ParallelExecutor:
    """Legacy multi-device executor facade (reference
    parallel_executor.cc): delegates to Executor."""

    def __init__(self, use_cuda=False, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers=1, trainer_id=0,
                 scope=None):
        self._program = main_program or _main_program
        self._exe = Executor('gpu' if use_cuda else 'cpu')

    def run(self, fetch_list, feed=None, feed_dict=None,
            return_numpy=True):
        return self._exe.run(self._program, feed=feed or feed_dict,
                             fetch_list=fetch_list,
                             return_numpy=return_numpy)


# -- program/vars (de)serialization (reference static/io.py) ----------------

def serialize_program(feed_vars, fetch_vars, program=None, **kwargs):
    payload = _export_payload(program or _main_program, feed_vars,
                              fetch_vars)
    return pickle.dumps(payload, protocol=4)


def deserialize_program(data):
    return LoadedProgram._from_payload(pickle.loads(data))


def serialize_persistables(feed_vars, fetch_vars, program=None, **kwargs):
    """Weights of the program's recorded parameters (+ global-scope vars),
    keyed by name or discovery index, in io_save's tensor payloads."""
    state = {k: p.detach()
             for k, p in _program_state(program or _main_program).items()}
    for n, t in _global_scope._vars.items():
        state.setdefault(n, t)
    return pickle.dumps(io_save._to_saveable(state), protocol=4)


def _assign(target, value):
    with torch.no_grad():
        target.copy_(torch.as_tensor(value))


def deserialize_persistables(program, data, executor=None):
    state = io_save._from_saveable(pickle.loads(data))
    if program is not None and getattr(program, '_ops', None):
        for key, p in _program_state(program).items():
            if key in state:
                _assign(p, state[key])
    for n, value in state.items():
        if n in _global_scope._vars:
            _assign(_global_scope._vars[n], value)
    return state


def save_to_file(path, content):
    with open(path, 'wb') as f:
        f.write(content)


def load_from_file(path):
    with open(path, 'rb') as f:
        return f.read()


def _var_names(vars):
    name_of = {id(t): n for n, t in _global_scope._vars.items()}
    return [name_of.get(id(v), 'var_%d' % i) for i, v in enumerate(vars)]


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    vars = vars or list(_global_scope._vars.values())
    state = dict(zip(_var_names(vars), (v.detach() for v in vars)))
    io_save.save(state, os.path.join(dirname, filename or '__vars__'))


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    state = io_save.load(os.path.join(dirname, filename or '__vars__'),
                         return_numpy=True)
    if vars:
        for name, v in zip(_var_names(vars), vars):
            if name in state:
                _assign(v, state[name])
    return state


def load_program_state(model_path, var_list=None):
    """numpy-level state surgery (reference io.py:2144)."""
    return io_save.load(model_path, return_numpy=True)


def set_program_state(program, state_dict):
    """Copy values into the global scope's vars and the program's
    parameters of the same names."""
    targets = dict(_program_state(program)) if program is not None else {}
    targets.update(_global_scope._vars)
    for n, value in state_dict.items():
        if n in targets:
            _assign(targets[n], value)


def normalize_program(program, feed_vars, fetch_vars, **kwargs):
    """Prune to the feed->fetch computation (reference normalize_program):
    returns the self-contained LoadedProgram."""
    return LoadedProgram._from_payload(
        _export_payload(program, feed_vars, fetch_vars))


from .. import amp  # noqa: F401,E402 — paddle.static.amp submodule parity
