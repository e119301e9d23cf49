"""paddle.utils parity (cpp_extension, op_benchmark, misc helpers;
counterpart of paddle_tpu/utils/__init__.py)."""
import os
import tempfile

from . import cpp_extension  # noqa: F401

__all__ = ['cpp_extension', 'try_import', 'require_version', 'deprecated',
           'run_check', 'download', 'unique_name',
           'profiler', 'ProfilerOptions', 'get_profiler']


def try_import(module_name, err_msg=None):
    """reference utils/lazy_import.py try_import."""
    import importlib
    try:
        return importlib.import_module(module_name)
    except ImportError as e:
        raise ImportError(err_msg or ('%s is required: %s'
                                      % (module_name, e)))


def require_version(min_version, max_version=None):
    """reference utils/install_check-style version gate over THIS
    framework's version."""
    from .. import __version__

    def key(v):
        return tuple(int(x) for x in str(v).split('.')[:3])
    if key(__version__) < key(min_version):
        raise Exception('paddle_tpu_torch >= %s required, found %s'
                        % (min_version, __version__))
    if max_version is not None and key(__version__) > key(max_version):
        raise Exception('paddle_tpu_torch <= %s required, found %s'
                        % (max_version, __version__))
    return True


def deprecated(update_to='', since='', reason=''):
    """reference utils/deprecated decorator."""
    import functools
    import warnings

    def decorate(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            warnings.warn(
                '%s is deprecated since %s%s%s'
                % (fn.__name__, since or 'this release',
                   ', use %s instead' % update_to if update_to else '',
                   '. %s' % reason if reason else ''),
                DeprecationWarning)
            return fn(*args, **kwargs)
        return wrapper
    return decorate


def run_check(device=None):
    """reference utils/install_check.run_check: one Linear forward,
    backward and SGD step on `device` (the current device when None: the
    card unless set_device('cpu') changed it)."""
    import torch

    from .. import nn, optimizer
    from ..framework import device as device_mod
    dev = device_mod.resolve(device)
    lin = nn.Linear(4, 2, device=dev)
    x = torch.ones((2, 4), device=dev)
    loss = lin(x).sum()
    loss.backward()
    opt = optimizer.SGD(learning_rate=0.1, parameters=lin.parameters())
    opt.step()
    print('paddle_tpu_torch is installed successfully!')
    return True


def download(url, path=None, md5sum=None):
    raise RuntimeError('this environment has no network egress — place '
                       'the file locally and pass its path '
                       '(reference utils/download.get_path_from_url)')


class unique_name:
    """reference fluid unique_name namespace (generate/guard)."""
    _counters = {}

    @staticmethod
    def generate(key):
        c = unique_name._counters.get(key, 0)
        unique_name._counters[key] = c + 1
        return '%s_%d' % (key, c)


from .. import profiler as _profiler_mod  # noqa: E402
Profiler = _profiler_mod.Profiler


class profiler:
    """paddle.utils.profiler shim (reference utils/profiler.py wraps the
    fluid profiler): maps onto paddle_tpu_torch.profiler."""

    class ProfilerOptions:
        _DEFAULTS = {'batch_range': [10, 10], 'state': 'All',
                     'sorted_key': 'total', 'tracer_option': 'Default',
                     'profile_path': os.path.join(tempfile.gettempdir(),
                                                  'profile'),
                     'exit_on_finished': True, 'timer_only': True}

        def __init__(self, options=None):
            self._options = dict(self._DEFAULTS)
            self._options.update(options or {})

        def __getitem__(self, name):
            if name not in self._options:
                raise ValueError('ProfilerOptions does not have an option '
                                 'named %s' % name)
            return self._options[name]

    @staticmethod
    def get_profiler(*a, **k):
        return _profiler_mod

    @staticmethod
    def start_profiler(*a, **k):
        return _profiler_mod.start_profiler(*a, **k)

    @staticmethod
    def stop_profiler(*a, **k):
        return _profiler_mod.stop_profiler(*a, **k)


ProfilerOptions = profiler.ProfilerOptions
get_profiler = profiler.get_profiler
