"""Runtime flags (counterpart of paddle_tpu/framework/flags.py; reference:
paddle/fluid/platform/flags.cc).

One registry: a FLAGS_<name> environment variable overrides a default at
import, set_flags changes a value at run time. Where a flag means
something to torch on CUDA its setter maps it there:
`cudnn_deterministic` onto torch.backends.cudnn.deterministic, and
`tpu_matmul_precision` onto torch.set_float32_matmul_precision ('default'
is 'highest', so f32 matmuls stay f32 unless a user asks). The other flags
are stored and read back, for compatibility only, as in the JAX package.
A setter runs when set_flags changes its flag, not at import: importing
the package changes no torch state.
"""
import os

import torch

_REGISTRY = {}


class _Flag:
    __slots__ = ('name', 'value', 'typ', 'help', 'on_set')

    def __init__(self, name, default, typ, help='', on_set=None):
        self.name = name
        self.value = default
        self.typ = typ
        self.help = help
        self.on_set = on_set


def define_flag(name, default, help='', on_set=None):
    typ = type(default)
    f = _Flag(name, default, typ, help, on_set)
    env = os.environ.get('FLAGS_' + name)
    if env is not None:
        f.value = _parse(env, typ)
    _REGISTRY[name] = f
    return f


def _parse(s, typ):
    if typ is bool:
        return s.lower() in ('1', 'true', 'yes')
    return typ(s)


def set_flags(flags):
    """Set {name or FLAGS_name: value}; an unknown name is registered."""
    for k, v in flags.items():
        name = k[6:] if k.startswith('FLAGS_') else k
        if name not in _REGISTRY:
            define_flag(name, v)
            continue
        f = _REGISTRY[name]
        f.value = _parse(v, f.typ) if isinstance(v, str) and \
            f.typ is not str else v
        if f.on_set:
            f.on_set(f.value)


def get_flags(flags):
    """{name as asked: value} for the registered names among `flags` (a
    name or a list of names)."""
    if isinstance(flags, str):
        flags = [flags]
    out = {}
    for k in flags:
        name = k[6:] if k.startswith('FLAGS_') else k
        if name in _REGISTRY:
            out[k] = _REGISTRY[name].value
    return out


def flag_value(name, default=None):
    f = _REGISTRY.get(name)
    return f.value if f is not None else default


def _set_detect_anomaly(v):
    torch.autograd.set_detect_anomaly(bool(v))


def _set_cudnn_deterministic(v):
    torch.backends.cudnn.deterministic = bool(v)


# the JAX precision names and torch's own, as torch names them
_PRECISIONS = {'default': 'highest', 'float32': 'highest',
               'highest': 'highest', 'tensorfloat32': 'high', 'high': 'high',
               'bfloat16': 'medium', 'medium': 'medium'}


def _set_matmul_precision(v):
    if v not in _PRECISIONS:
        raise ValueError('tpu_matmul_precision %r: one of %s'
                         % (v, ', '.join(sorted(_PRECISIONS))))
    torch.set_float32_matmul_precision(_PRECISIONS[v])


define_flag('check_nan_inf', False,
            'raise where a backward produces nan / inf (autograd anomaly '
            'detection)', on_set=_set_detect_anomaly)
define_flag('fraction_of_gpu_memory_to_use', 0.92,
            'compat only; the CUDA caching allocator grows on demand')
define_flag('allocator_strategy', 'auto_growth', 'compat only')
define_flag('cudnn_deterministic', True,
            'torch.backends.cudnn.deterministic',
            on_set=_set_cudnn_deterministic)
define_flag('benchmark', False, 'compat only')
define_flag('paddle_num_threads', 1, 'host threads hint, compat only')
define_flag('use_pinned_memory', True, 'compat only')
define_flag('eager_delete_tensor_gb', 0.0, 'compat only')
define_flag('max_inplace_grad_add', 0, 'compat only')
define_flag('cudnn_exhaustive_search', False, 'compat only')
define_flag('sort_sum_gradient', False, 'compat only')
define_flag('tpu_matmul_precision', 'default',
            "torch.set_float32_matmul_precision ('default' is 'highest'; "
            "'high' allows TF32)", on_set=_set_matmul_precision)
