"""Build/load machinery for C++ custom ops (see package docstring)."""
import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np
import torch

__all__ = ['load', 'load_op_library', 'setup', 'CppExtension',
           'CUDAExtension', 'BuildExtension', 'get_include_dir']

# the header's PDDtype codes, as the JAX package's loader reads them
_DTYPE_CODES = {0: torch.float32, 1: torch.float64, 2: torch.int32,
                3: torch.int64}
_DTYPE_TO_CODE = {v: k for k, v in _DTYPE_CODES.items()}
_PD_MAX_DIMS = 8
# -fno-gnu-unique: the header's op registry is a static local of an inline
# function, which g++ otherwise makes one symbol for the whole process, so
# every library loaded would list the ops of the libraries loaded before
# it (the JAX package's loader builds so, and its libraries share one
# registry); with the flag each library keeps its own
_CXX_FLAGS = ['-O2', '-shared', '-fPIC', '-std=c++17', '-fno-gnu-unique']
_LOCK = threading.Lock()
# one module a built library: torch registers an op's qualified name once a
# process, so a library loaded again is the module loaded first
_MODULES = {}


class PDTensor(ctypes.Structure):
    _fields_ = [('data', ctypes.c_void_p),
                ('ndim', ctypes.c_int64),
                ('shape', ctypes.c_int64 * _PD_MAX_DIMS),
                ('dtype', ctypes.c_int32)]


def get_include_dir():
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'include')


def _compile(sources, name, extra_cflags=None, extra_ldflags=None,
             extra_include_paths=None, build_directory=None, verbose=False):
    build_dir = build_directory or os.path.join(
        tempfile.gettempdir(), 'paddle_tpu_torch_extensions')
    os.makedirs(build_dir, exist_ok=True)
    key = hashlib.sha256()
    # hash the framework header too: an ABI change (PDTensor layout,
    # pd_op_meta contract) must invalidate cached .so artifacts
    header_files = [os.path.join(get_include_dir(), 'pd_extension.h')]
    for p in (extra_include_paths or []):
        if os.path.isdir(p):
            header_files += sorted(
                os.path.join(p, f) for f in os.listdir(p)
                if f.endswith(('.h', '.hpp')))
    for s in list(sources) + header_files:
        with open(s, 'rb') as f:
            key.update(f.read())
    key.update(' '.join(_CXX_FLAGS + (extra_cflags or []) +
                        (extra_ldflags or [])).encode())
    out = os.path.join(build_dir, '%s_%s.so' % (name, key.hexdigest()[:12]))
    if os.path.exists(out):
        return out
    # build beside the target and rename into place, so processes that
    # build one source at once never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=build_dir)
    os.close(fd)
    cmd = ['g++'] + _CXX_FLAGS + ['-I', get_include_dir()]
    for p in (extra_include_paths or []):
        cmd += ['-I', p]
    cmd += (extra_cflags or []) + ['-o', tmp] + list(sources) + \
        (extra_ldflags or [])
    if verbose:
        print('compiling:', ' '.join(cmd))
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError('extension compile failed:\n%s' % proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _metas(shapes_dtypes, data=None):
    """A PDTensor array over (shape, torch dtype) pairs; `data` the data
    pointers (None: metadata only, for pd_infer_shape)."""
    metas = (PDTensor * len(shapes_dtypes))()
    for i, (shape, dtype) in enumerate(shapes_dtypes):
        if dtype not in _DTYPE_TO_CODE:
            raise TypeError('custom ops take float32, float64, int32 and '
                            'int64 tensors; got %s' % dtype)
        if len(shape) > _PD_MAX_DIMS:
            raise ValueError('custom ops take up to %d dims; got shape %s'
                             % (_PD_MAX_DIMS, tuple(shape)))
        metas[i].data = data[i] if data is not None else None
        metas[i].ndim = len(shape)
        for j, d in enumerate(shape):
            metas[i].shape[j] = int(d)
        metas[i].dtype = _DTYPE_TO_CODE[dtype]
    return metas


class _LoadedOp:
    """One custom op: callable over tensors (CPU or CUDA), traceable by
    torch.compile, differentiable when a grad kernel was registered.

    The op is the torch.library custom op `<namespace>::<name>`; its fake
    implementation takes the output shapes from pd_infer_shape over
    metadata, and its autograd formula runs the grad kernel, itself the
    custom op `<namespace>::<name>_grad`, on (forward inputs, cotangents).
    The kernels are host code: CPU tensors go to them directly, CUDA
    tensors are copied to the host and the outputs back, each such call
    counted in `host_round_trips`."""

    def __init__(self, lib, idx, name, meta, namespace):
        self._lib = lib
        self._idx = idx
        self.name = name
        (self.n_inputs, self.n_outputs, self._has_infer,
         self.grad_n_inputs, self.grad_n_outputs, self._has_grad) = \
            [int(m) for m in meta]
        self.host_round_trips = 0
        self._op = self._define(namespace, name, self.n_inputs,
                                self.n_outputs, False)
        self._grad_op = self._define(
            namespace, name + '_grad', self.grad_n_inputs,
            self.grad_n_outputs, True) if self._has_grad else None
        self._op.register_autograd(self._backward,
                                   setup_context=self._setup_context)

    def _define(self, namespace, op_name, n_in, n_out, is_grad):
        args = ', '.join('Tensor x%d' % i for i in range(n_in))
        rets = 'Tensor' if n_out == 1 else \
            '(%s)' % ', '.join(['Tensor'] * n_out)
        op = torch.library.custom_op(
            '%s::%s' % (namespace, op_name),
            lambda *xs: self._run(is_grad, xs), mutates_args=(),
            schema='(%s) -> %s' % (args, rets))
        op.register_fake(lambda *xs: self._fake(is_grad, xs))
        return op

    def _out_specs(self, is_grad, inputs):
        """(shape, dtype) of each output. Grad outputs are grads of the
        forward inputs and take their shapes; forward outputs come from
        pd_infer_shape over the inputs' metadata (data NULL)."""
        if is_grad:
            return [(tuple(inputs[i].shape), inputs[i].dtype)
                    for i in range(self.grad_n_outputs)]
        ins = _metas([(tuple(t.shape), t.dtype) for t in inputs])
        outs = (PDTensor * self.n_outputs)()
        rc = self._lib.pd_infer_shape(self._idx, ins, len(inputs), outs,
                                      self.n_outputs)
        if rc != 0:
            raise RuntimeError('pd_infer_shape(%s) failed rc=%d'
                               % (self.name, rc))
        return [(tuple(m.shape[i] for i in range(m.ndim)),
                 _DTYPE_CODES[m.dtype]) for m in outs]

    def _fake(self, is_grad, inputs):
        device = inputs[0].device if inputs else torch.device('cpu')
        outs = [torch.empty(s, dtype=d, device=device)
                for s, d in self._out_specs(is_grad, inputs)]
        return outs[0] if len(outs) == 1 else tuple(outs)

    def _run(self, is_grad, inputs):
        device = inputs[0].device if inputs else torch.device('cpu')
        if device.type != 'cpu':
            self.host_round_trips += 1
        host = [t.detach().to('cpu').contiguous() for t in inputs]
        outs = [torch.empty(s, dtype=d)
                for s, d in self._out_specs(is_grad, host)]
        ins = _metas([(tuple(t.shape), t.dtype) for t in host],
                     [t.data_ptr() if t.numel() else None for t in host])
        out_metas = _metas([(tuple(t.shape), t.dtype) for t in outs],
                           [t.data_ptr() if t.numel() else None
                            for t in outs])
        rc = self._lib.pd_run(self._idx, 1 if is_grad else 0, ins,
                              len(host), out_metas, len(outs))
        if rc != 0:
            raise RuntimeError('custom op %s%s failed rc=%d'
                               % (self.name, ' (grad)' if is_grad else '',
                                  rc))
        outs = [t.to(device) for t in outs]
        return outs[0] if len(outs) == 1 else tuple(outs)

    @staticmethod
    def _setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    def _backward(self, ctx, *cotangents):
        if self._grad_op is None:
            raise NotImplementedError(
                'custom op %s has no grad kernel registered '
                '(PD_BUILD_GRAD_OP missing)' % self.name)
        grads = self._grad_op(*ctx.saved_tensors, *cotangents)
        return grads if isinstance(grads, tuple) else (grads,)

    def __call__(self, *args):
        if len(args) != self.n_inputs:
            raise ValueError('%s expects %d inputs, got %d'
                             % (self.name, self.n_inputs, len(args)))
        tensors = [a if isinstance(a, torch.Tensor)
                   else torch.as_tensor(np.asarray(a)) for a in args]
        return self._op(*tensors)


class _Module:
    """Namespace holding the ops of one loaded extension."""

    def __init__(self, name, ops):
        self.__name__ = name
        self._ops = {op.name: op for op in ops}
        for op in ops:
            setattr(self, op.name, op)

    def op_names(self):
        return sorted(self._ops)


def load_op_library(so_path, name=None):
    """dlopen an already-built extension and register its ops.

    Parity: paddle.utils.cpp_extension.load_op_library /
    framework/custom_operator.cc LoadOpMetaInfoAndRegisterOp. The ops of
    one library share the torch.library namespace `pd_<hash of its
    path>`; a library loaded again returns the module loaded first.
    """
    so_path = os.path.realpath(so_path)
    with _LOCK:
        if so_path in _MODULES:
            return _MODULES[so_path]
        lib = ctypes.CDLL(so_path)
        lib.pd_num_ops.restype = ctypes.c_int
        lib.pd_num_ops.argtypes = []
        lib.pd_op_name.restype = ctypes.c_char_p
        lib.pd_op_name.argtypes = [ctypes.c_int]
        lib.pd_op_meta.restype = ctypes.c_int
        lib.pd_op_meta.argtypes = [ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_int64)]
        lib.pd_infer_shape.restype = ctypes.c_int
        lib.pd_infer_shape.argtypes = [
            ctypes.c_int, ctypes.POINTER(PDTensor), ctypes.c_int,
            ctypes.POINTER(PDTensor), ctypes.c_int]
        lib.pd_run.restype = ctypes.c_int
        lib.pd_run.argtypes = [ctypes.c_int, ctypes.c_int,
                               ctypes.POINTER(PDTensor), ctypes.c_int,
                               ctypes.POINTER(PDTensor), ctypes.c_int]
        namespace = 'pd_' + hashlib.sha256(so_path.encode()).hexdigest()[:16]
        metas = []
        for i in range(lib.pd_num_ops()):
            op_name = lib.pd_op_name(i).decode()
            meta = (ctypes.c_int64 * 6)()
            lib.pd_op_meta(i, meta)
            n_in, n_out = int(meta[0]), int(meta[1])
            g_in, g_out, has_grad = int(meta[3]), int(meta[4]), \
                bool(meta[5])
            if has_grad and (g_in != n_in + n_out or g_out != n_in):
                # the autograd formula supplies (fwd inputs...,
                # cotangents...) and expects one grad per fwd input —
                # catch arity mismatches at load time instead of as an
                # OOB read inside the native kernel
                raise RuntimeError(
                    'grad kernel of %s declares %d inputs/%d outputs; '
                    'expected %d inputs (fwd inputs + fwd outputs) and %d '
                    'outputs (one grad per fwd input)'
                    % (op_name, g_in, g_out, n_in + n_out, n_in))
            metas.append((i, op_name, list(meta)))
        if not metas:
            raise RuntimeError('%s exports no custom ops (PD_BUILD_OP '
                               'missing?)' % so_path)
        ops = [_LoadedOp(lib, i, op_name, meta, namespace)
               for i, op_name, meta in metas]
        module = _Module(name or os.path.basename(so_path), ops)
        _MODULES[so_path] = module
        return module


def load(name, sources, extra_cflags=None, extra_cuda_cflags=None,
         extra_ldflags=None, extra_include_paths=None,
         build_directory=None, verbose=False):
    """JIT-compile `sources` against pd_extension.h and return a module
    whose attributes are the registered ops (paddle cpp_extension.load
    parity; extra_cuda_cflags accepted and ignored — host C++ only, as in
    the JAX package)."""
    so = _compile(sources, name, extra_cflags=extra_cflags,
                  extra_ldflags=extra_ldflags,
                  extra_include_paths=extra_include_paths,
                  build_directory=build_directory, verbose=verbose)
    return load_op_library(so, name=name)


# ---- setuptools-style surface ---------------------------------------------
class CppExtension:
    def __init__(self, sources, *args, **kwargs):
        self.sources = sources
        self.kwargs = kwargs


# accepted for API compatibility; compiles the same host C++ path
CUDAExtension = CppExtension


class BuildExtension:
    """Minimal build_ext stand-in: building produces the .so eagerly."""

    @staticmethod
    def with_options(**_):
        return BuildExtension


def setup(name, ext_modules=None, **kwargs):
    """Build each extension now and return the artifact paths (the
    reference's setuptools path writes an installable egg; here the build
    directory module is the product, loadable via load_op_library)."""
    outs = []
    for ext in (ext_modules or []):
        outs.append(_compile(ext.sources, name,
                             **{k: v for k, v in ext.kwargs.items()
                                if k in ('extra_cflags', 'extra_ldflags',
                                         'extra_include_paths',
                                         'build_directory', 'verbose')}))
    return outs
