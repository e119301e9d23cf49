"""Device selection (counterpart of paddle_tpu/framework/device.py).

Entry points run on the current device unless the caller passes one; the
current device is the card ('cuda') until set_device changes it. With no
CUDA present a CUDA device raises instead of dropping to the CPU. Paddle's
names are accepted: 'gpu', 'gpu:1', 'cpu' (and torch's 'cuda', 'cuda:1'),
and the Place classes, whose `device` is the torch.device they name.
XPUPlace and NPUPlace are the JAX package's place classes for devices the
port does not run on: they can be made and compared, and placing a tensor
on one raises a ValueError that names it.
"""
import torch

DEFAULT_DEVICE = 'cuda'
_STATE = {'device': DEFAULT_DEVICE}


def _torch_name(device):
    """A Paddle or torch device name as torch spells it."""
    if isinstance(device, torch.device):
        return str(device)
    kind, sep, idx = str(device).lower().partition(':')
    if kind in ('gpu', 'cuda'):
        return 'cuda' + sep + idx
    if kind == 'cpu':
        return 'cpu'
    if kind in ('tpu', 'xpu', 'npu', 'xla'):
        raise ValueError(
            'device %r: paddle_tpu_torch runs on CUDA GPUs and the CPU '
            "('gpu', 'gpu:N', 'cpu'); the TPU package is paddle_tpu"
            % str(device))
    raise ValueError('unknown device %r' % str(device))


def resolve(device=None):
    """A torch.device for `device` (the current device when None); a CUDA
    device raises when CUDA is not available."""
    dev = torch.device(_torch_name(_STATE['device'] if device is None
                                   else device))
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "device %r requested but CUDA is not available; pass "
            "device='cpu' to run on the CPU" % str(device or dev))
    return dev


def set_device(device):
    """Make `device` ('gpu', 'gpu:N', 'cpu') the default that resolve()
    and every entry point without a device use; returns the torch.device.
    'gpu' without CUDA raises."""
    dev = resolve(device)
    _STATE['device'] = str(dev)
    return dev


def get_device():
    """The current device as Paddle names it: 'gpu:N' or 'cpu:0'."""
    dev = torch.device(_torch_name(_STATE['device']))
    if dev.type == 'cuda':
        return 'gpu:%d' % (dev.index or 0)
    return 'cpu:0'


def device_count(backend=None):
    """CUDA devices visible (backend None or 'gpu'); 1 for 'cpu'."""
    if backend is not None and _torch_name(backend) == 'cpu':
        return 1
    return torch.cuda.device_count()


class CPUPlace:
    def __init__(self):
        self.device = torch.device('cpu')

    def __repr__(self):
        return 'CPUPlace'


class CUDAPlace:
    def __init__(self, id=0):
        self.device = torch.device('cuda', id)

    def get_device_id(self):
        return self.device.index

    def __repr__(self):
        return 'CUDAPlace(%d)' % self.device.index


class CUDAPinnedPlace:
    """Host memory that CUDA copies read directly; tensors placed here live
    on the CPU."""

    def __init__(self):
        self.device = torch.device('cpu')

    def __repr__(self):
        return 'CUDAPinnedPlace'


class _AbsentPlace:
    """A place of a device the port has no backend for (torch here runs on
    CUDA and the CPU)."""

    def __init__(self, id=0):
        self.device_id = id

    def get_device_id(self):
        return self.device_id

    @property
    def device(self):
        raise ValueError(
            '%r: paddle_tpu_torch runs on CUDA GPUs and the CPU '
            "('gpu', 'gpu:N', 'cpu'); it has no %s device"
            % (self, type(self).__name__[:3]))

    def __eq__(self, other):
        return type(self) is type(other) and \
            self.device_id == other.device_id

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    def __repr__(self):
        return '%s(%d)' % (type(self).__name__, self.device_id)


class XPUPlace(_AbsentPlace):
    pass


class NPUPlace(_AbsentPlace):
    pass


def is_compiled_with_cuda():
    return torch.version.cuda is not None


def is_compiled_with_rocm():
    return torch.version.hip is not None


def is_compiled_with_xpu():
    return False


def is_compiled_with_npu():
    return False


def get_cudnn_version():
    """cuDNN's version as an int (e.g. 90100), None without cuDNN."""
    return torch.backends.cudnn.version() \
        if torch.backends.cudnn.is_available() else None
