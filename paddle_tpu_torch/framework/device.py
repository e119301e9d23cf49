"""Device selection. Entry points run on the card unless the caller passes
device='cpu'; with no CUDA present the default raises instead of dropping
to the CPU."""
import torch

DEFAULT_DEVICE = 'cuda'


def resolve(device=DEFAULT_DEVICE):
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "device %r requested but CUDA is not available; pass "
            "device='cpu' to run on the CPU" % str(device))
    return dev
