"""Common functionals (counterpart of paddle_tpu/nn/functional/common.py):
linear, embedding, eval-mode dropout."""
import torch


def linear(x, weight, bias=None):
    """y = x @ W + b with W laid out [in, out] (the paddle convention)."""
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias


def embedding(x, weight):
    """Row lookup: out[..., :] = weight[x[...], :]."""
    return weight[x]


def dropout(x, p=0.5, training=True):
    """Eval-mode dropout (the identity). Training-mode dropout comes with
    the training slice."""
    if training and p:
        raise NotImplementedError(
            'training-mode dropout is not ported yet; call model.eval()')
    return x
