"""to_static error source-mapping (counterpart of paddle_tpu/jit/error.py;
reference: python/paddle/fluid/dygraph/dygraph_to_static/error.py).

A failure while TorchDynamo traces, or Inductor compiles, a @to_static
function otherwise surfaces as a stack of compiler internals. This module
re-raises it as ToStaticError naming the user's file, line and source,
with a hint for the usual causes. Errors raised while an already compiled
program runs (a kernel's check, device memory) are not compile errors and
propagate untouched, as do the user's own exceptions.
"""
import contextlib
import linecache
import os

import torch

__all__ = ['ToStaticError', 'trace_error_scope']

_SKIP_DIRS = (
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),  # the port
    os.path.dirname(os.path.abspath(torch.__file__)),              # torch
)


class ToStaticError(Exception):
    """A compile-time failure inside @to_static, framed at user source."""


def _dynamo_exc():
    import torch._dynamo.exc as exc
    return exc


def _is_trace_error(exc):
    """True for failures of the compiler itself: TorchDynamo's exception
    family (unsupported constructs and graph breaks under full_graph,
    failed fake-tensor propagation, the backend's compile errors, the
    recompile limit)."""
    return isinstance(exc, _dynamo_exc().TorchDynamoException)


def _frames(exc):
    """(file, line, function) of the frames the error passed through, the
    user's first: Dynamo's record of the user stack it was tracing, then
    the Python traceback."""
    out = []
    stack = getattr(exc, 'real_stack', None) or []
    for fr in stack:
        out.append((os.path.abspath(fr.filename), fr.lineno, fr.name))
    tb = exc.__traceback__
    while tb is not None:
        f = tb.tb_frame
        out.append((os.path.abspath(f.f_code.co_filename), tb.tb_lineno,
                    f.f_code.co_name))
        tb = tb.tb_next
    out = [fr for fr in out if os.path.exists(fr[0])]
    user = [fr for fr in out if not fr[0].startswith(_SKIP_DIRS)]
    # a model of the port's own (GPTForCausalLM) is the user's code too:
    # without frames outside the port, name the port's frame
    return user or [fr for fr in out if not fr[0].startswith(_SKIP_DIRS[1])]


def _hint_for(exc):
    text = str(exc)
    low = text.lower()
    if 'data-dependent' in low or 'generic_jump' in low or \
            'data dependent' in low and 'branch' in low:
        return ('data-dependent Python control flow cannot be compiled: '
                'branch with torch.cond (or torch.where) and keep if / '
                'while on Python values, not on Tensor values')
    if '.item()' in low or 'tensor.item' in low or 'int(' in low or \
            'unbacked' in low or 'call_function int' in low or \
            'data dependent' in low:
        return ('a Tensor was converted to a Python number while '
                'compiling (int / float / bool / item()): keep the value a '
                'Python int, or keep the computation in tensor ops; if it '
                'is an if / while on a Tensor, use torch.cond')
    if isinstance(exc, _dynamo_exc().Unsupported):
        return ('the construct breaks the graph, and to_static compiles '
                'one graph (full_graph=True): rewrite it, or pass '
                'full_graph=False to compile in pieces')
    return ('the operation is incompatible with compiling; see the chained '
            'error for details')


@contextlib.contextmanager
def trace_error_scope(user_fn):
    """Re-raise compile errors as ToStaticError pointing at user code."""
    try:
        yield
    except Exception as e:
        if not _is_trace_error(e):
            raise
        frames = _frames(e)
        target = None
        try:
            target_file = os.path.abspath(user_fn.__code__.co_filename)
            for fr in frames:
                if fr[0] == target_file:
                    target = fr  # the last frame inside the user's file
        except AttributeError:
            pass
        if target is None and frames:
            target = frames[-1]
        if target is None:
            raise
        fname, lineno, func = target
        src = linecache.getline(fname, lineno).strip()
        raise ToStaticError(
            'error while compiling @to_static function %r:\n'
            '  File "%s", line %d, in %s\n'
            '    %s\n'
            'Hint: %s\n'
            '(original error chained below)'
            % (getattr(user_fn, '__name__', user_fn), fname, lineno, func,
               src, _hint_for(e))) from e
