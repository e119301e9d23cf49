"""C inference API (counterpart of paddle_tpu/capi; reference:
paddle/fluid/inference/capi_exp/ — the plain-C surface over the predictor
that the reference's Go API and third-party runtimes build on).

`build_capi()` compiles libpaddle_tpu_torch_c_<hash>.so from pd_capi.cc
with the host CPython's embed flags (g++; the name is a hash of the
sources and the flags, so an edit or another interpreter builds anew)
into paddle_tpu_torch/_build/, at first use, and returns its path. C
programs include pd_capi.h, link against the .so, call PD_Init(repo_root)
once, then drive Config / Predictor / Run as the Python surface does. The
device strings are "gpu" (the default) and "cpu"; a card request without
CUDA fails through PD_GetLastError and never falls back to the CPU.

goapi/ holds the Go shim over the same header (cgo).
"""
import hashlib
import os
import subprocess
import sysconfig

__all__ = ['build_capi', 'header_path']

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), '_build')


def header_path():
    return os.path.join(_DIR, 'pd_capi.h')


def _embed_flags():
    inc = sysconfig.get_path('include')
    libdir = sysconfig.get_config_var('LIBDIR') or ''
    ver = sysconfig.get_config_var('LDVERSION') or \
        sysconfig.get_config_var('VERSION')
    cflags = ['-I', inc]
    ldflags = ['-L', libdir, '-lpython%s' % ver, '-ldl', '-lm']
    return cflags, ldflags


def build_capi(build_directory=None, verbose=False):
    """Compile (or reuse) libpaddle_tpu_torch_c_<hash>.so; returns its
    path."""
    build_dir = build_directory or _BUILD_DIR
    os.makedirs(build_dir, exist_ok=True)
    src = os.path.join(_DIR, 'pd_capi.cc')
    cflags, ldflags = _embed_flags()
    key = hashlib.sha256()
    for path in (src, header_path()):
        with open(path, 'rb') as f:
            key.update(f.read())
    # flags are part of the identity: an interpreter upgrade changes
    # -lpythonX.Y and must not reuse a .so linked against the old one
    key.update(' '.join(cflags + ldflags).encode())
    out = os.path.join(build_dir,
                       'libpaddle_tpu_torch_c_%s.so' % key.hexdigest()[:12])
    if os.path.exists(out):
        return out
    # compile to a private temp path and rename into place: two builders
    # racing on a cache miss each write their own file, and a concurrent
    # dlopen can never map a half-written library (rename is atomic on
    # the same filesystem)
    tmp = '%s.tmp.%d' % (out, os.getpid())
    cmd = (['g++', '-O2', '-shared', '-fPIC', '-std=c++17', '-I', _DIR]
           + cflags + ['-o', tmp, src] + ldflags)
    if verbose:
        print('compiling:', ' '.join(cmd))
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise RuntimeError('capi build failed:\n%s' % proc.stderr[-2000:])
    os.rename(tmp, out)
    return out
