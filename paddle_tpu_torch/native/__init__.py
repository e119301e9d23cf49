"""Native (C++) host components of the port, built on demand with g++
(counterpart of paddle_tpu/native/__init__.py).

The sources are the port's own copies of the JAX package's:
  graph_store.cc     - sharded graph + alias-method sampling (graph engine)
  datafeed.cc        - MultiSlot format parser (PS ingestion hot loop)
  embedding_table.cc - one sparse-embedding shard (rows + optimizer slots)
They run on the host; the card never sees them.

Each `<name>.cc` here is compiled into `paddle_tpu_torch/_build/native/
lib<name>-<hash>.so`, the hash covering the source and the flags, so an
edited source builds anew. The build writes a temporary file and renames
it into place, so processes building at once never load a half-written
library. The JAX package writes its libraries beside its sources; this
loader never reads, builds or opens anything outside this package.
"""
import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), '_build', 'native')
CXX_FLAGS = ['-O2', '-shared', '-fPIC', '-std=c++17', '-pthread']
_BUILD_LOCK = threading.Lock()
_LIBS = {}


def _target(name):
    """Where `<name>.cc` builds: _build/native/lib<name>-<hash>.so."""
    src = os.path.join(_DIR, name + '.cc')
    digest = hashlib.sha256(' '.join(CXX_FLAGS).encode())
    with open(src, 'rb') as f:
        digest.update(f.read())
    return src, os.path.join(BUILD_DIR, 'lib%s-%s.so'
                             % (name, digest.hexdigest()[:16]))


def _build(name, force=False):
    src, out = _target(name)
    if os.path.exists(out) and not force:
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(['g++'] + CXX_FLAGS + ['-o', tmp, src], check=True,
                       capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load_library(name):
    """Compile (cached) and dlopen a native helper; raises on failure so the
    caller can fall back to a Python implementation."""
    with _BUILD_LOCK:
        if name not in _LIBS:
            try:
                _LIBS[name] = ctypes.CDLL(_build(name))
            except OSError:
                # a library built elsewhere that this platform cannot load
                _LIBS[name] = ctypes.CDLL(_build(name, force=True))
        return _LIBS[name]


def available(name):
    try:
        load_library(name)
        return True
    except Exception:
        return False
