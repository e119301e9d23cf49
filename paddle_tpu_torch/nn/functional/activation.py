"""Activations (counterpart of paddle_tpu/nn/functional/activation.py)."""
import torch


def gelu(x, approximate=False):
    """approximate=True is the tanh form that GPT's MLP uses."""
    return torch.nn.functional.gelu(
        x, approximate='tanh' if approximate else 'none')
