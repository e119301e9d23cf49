"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface. It is compiled by `nvcc` for
sm_90a into `_build/lib<name>-<hash>.so` at first use, from the sources in
this package only, and loaded with ctypes. The hash covers the source, the
shared headers (`csrc/*.cuh`) and the flags, so an edited source builds
anew and an unchanged one is reused. Each lookup counts as a compile-cache
hit (library up to date) or miss (an nvcc run) in framework/compile_cache.py.
Nothing here runs at import time.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

from .framework import compile_cache

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, 'csrc')
DEFAULT_BUILD_DIR = os.path.join(_HERE, '_build')
# the persistent compile cache (framework/compile_cache.py can move it)
BUILD_DIR = DEFAULT_BUILD_DIR
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_loaded = {}


def nvcc_path():
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then
    /usr/local/cuda/bin/nvcc."""
    candidates = []
    if os.environ.get('CUDA_HOME'):
        candidates.append(os.path.join(os.environ['CUDA_HOME'], 'bin', 'nvcc'))
    found = shutil.which('nvcc')
    if found:
        candidates.append(found)
    candidates.append('/usr/local/cuda/bin/nvcc')
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError('nvcc not found (set CUDA_HOME or put nvcc on PATH); '
                       'the CUDA kernels are built from csrc/ at first use')


def _target(name):
    src = os.path.join(CSRC, name + '.cu')
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    # the shared headers are part of every kernel's source
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith('.cuh'))
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, 'rb') as f:
            digest.update(f.read())
    return src, os.path.join(BUILD_DIR, 'lib%s-%s.so' % (
        name, digest.hexdigest()[:16]))


def _start(name):
    """Start nvcc for csrc/<name>.cu unless its library is built; returns
    (process or None, temporary output, final path)."""
    src, lib = _target(name)
    compile_cache.note(hit=os.path.exists(lib))
    if os.path.exists(lib):
        return None, None, lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen([nvcc_path()] + NVCC_FLAGS + ['-o', tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, lib


def _finish(name, proc, tmp, lib):
    """Wait for a build started by _start; returns the compiler's output."""
    if proc is None:
        return ''
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError('nvcc failed for csrc/%s.cu (exit %d):\n%s'
                           % (name, proc.returncode, out))
    os.replace(tmp, lib)
    return out


def build(names):
    """Build every csrc/<name>.cu not built yet, one nvcc each, all started
    together. Returns {name: compiler output}."""
    started = {name: _start(name) for name in names}
    return {name: _finish(name, *started[name]) for name in names}


def load(name):
    """The ctypes handle of csrc/<name>.cu, built at first use."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(_target(name)[1])
    return lib
