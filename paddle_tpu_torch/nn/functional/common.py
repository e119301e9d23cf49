"""Common functionals (counterpart of paddle_tpu/nn/functional/common.py):
linear, embedding, dropout."""
import torch


def linear(x, weight, bias=None):
    """y = x @ W + b with W laid out [in, out] (the paddle convention)."""
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias


def embedding(x, weight):
    """Row lookup: out[..., :] = weight[x[...], :]."""
    return weight[x]


def dropout(x, p=0.5, training=True, generator=None):
    """Upscale-in-train dropout: each element is kept with probability
    1 - p and scaled by 1 / (1 - p); the identity in eval mode or at p = 0.
    The mask is drawn from `generator` (a torch.Generator on x's device;
    torch's default one when None). JAX's threefry bits cannot be
    reproduced, so the masks differ from the JAX package's; autograd keeps
    the forward's mask for the backward."""
    if not training or p == 0:
        return x
    if p == 1:
        return x * 0.0
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
