"""paddle.static (counterpart of paddle_tpu/static/): `InputSpec` only.

The JAX package's `Program` / `Executor` replay the ops that its
framework/core.py records; the port's layers are plain torch modules, so
the static graph needs a recorder over torch calls of its own. With it
come `Program`, `Executor`, `static.nn` (after the conv layers) and
`save_inference_model` / `load_inference_model`, in the next slice.
Asking for any of them raises NotImplementedError naming it.
"""
from .input_spec import InputSpec  # noqa: F401

__all__ = ['InputSpec']

_NEXT_SLICE = {
    'Program', 'Executor', 'program_guard', 'default_main_program',
    'default_startup_program', 'data', 'global_scope', 'scope_guard',
    'Variable', 'nn', 'save_inference_model', 'load_inference_model',
    'save', 'load', 'gradients', 'append_backward', 'CompiledProgram',
    'BuildStrategy', 'ExecutionStrategy', 'create_parameter',
    'create_global_var', 'cpu_places', 'cuda_places', 'name_scope',
}


def __getattr__(name):
    if name in _NEXT_SLICE:
        raise NotImplementedError(
            'paddle_tpu_torch.static.%s is not ported yet: the static graph '
            '(Program, Executor, static.nn, save_inference_model) needs a '
            'recorder over torch calls and comes with the next slice' % name)
    raise AttributeError('module %r has no attribute %r' % (__name__, name))
