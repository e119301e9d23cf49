"""paddle.hub shim (reference: python/paddle/hapi/hub.py; the port's copy
of paddle_tpu/hub.py). Local-directory sources only: there is no
downloader."""
import importlib.util
import os
import sys

__all__ = ['list', 'help', 'load']


def _load_entry(repo_dir):
    path = os.path.join(repo_dir, 'hubconf.py')
    spec = importlib.util.spec_from_file_location('hubconf', path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules['hubconf'] = mod
    spec.loader.exec_module(mod)
    return mod


def list(repo_dir, source='local', force_reload=False):
    if source != 'local':
        raise RuntimeError("only source='local' is supported (no egress)")
    mod = _load_entry(repo_dir)
    return [k for k in dir(mod) if callable(getattr(mod, k))
            and not k.startswith('_')]


def help(repo_dir, model, source='local', force_reload=False):
    mod = _load_entry(repo_dir)
    return getattr(mod, model).__doc__


def load(repo_dir, model, source='local', force_reload=False, **kwargs):
    if source != 'local':
        raise RuntimeError("only source='local' is supported (no egress)")
    mod = _load_entry(repo_dir)
    return getattr(mod, model)(**kwargs)
