"""ASP: automatic structured (n:m) sparsity (counterpart of
paddle_tpu/incubate/asp.py).

Parity: python/paddle/fluid/contrib/sparsity/ (utils.py create_mask /
check_sparsity / calculate_density, asp.py prune_model + ASPHelper,
fleet meta-optimizer asp_optimizer.py). The masks are computed in numpy
on the host, as in the JAX package (a weight crosses to the host once,
in f32), and applied to the weights in place on their device, so a
Parameter keeps its identity and an optimizer's slots stay valid.
`decorate(optimizer)` re-applies the masks after every `step()` (the
reference hooks the same way via OptimizerWithSparsityGuarantee): an
eager loop keeps the pattern, a TrainStep, which updates through the
optimizer's `_update`, does not (as in the JAX package).

A weight is pruned over its last dim in groups of m, and skipped when
that dim is not a multiple of m. A convolution's [out, in, kh, kw]
weight has kw last (1, 3 or 7 in the usual convnets), so those are
skipped before the flattened per-out-channel branch is reached; kept as
the JAX package has it.
"""
import numpy as np
import torch

__all__ = ['calculate_density', 'check_mask_1d', 'check_mask_2d',
           'create_mask', 'check_sparsity', 'prune_model', 'decorate',
           'reset_excluded_layers', 'set_excluded_layers', 'ASPHelper']

_EXCLUDED = set()


def _np(mat):
    """`mat` as a numpy array; a tensor comes to the host, a 16-bit float
    one as f32 (exact, and the same order of magnitudes)."""
    if torch.is_tensor(mat):
        t = mat.detach()
        if t.is_floating_point() and t.element_size() < 4:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(mat)


def calculate_density(mat):
    mat = _np(mat)
    return float(np.count_nonzero(mat)) / mat.size


def _group_view(mat, m):
    """Reshape the last dim into groups of m (pad refused — caller checks)."""
    arr = np.asarray(mat)
    if arr.shape[-1] % m:
        raise ValueError('last dim %d not divisible by m=%d'
                         % (arr.shape[-1], m))
    return arr.reshape(-1, m)


def check_mask_1d(mat, n, m):
    """True iff every group of m consecutive (row-major) elements has at
    most n nonzeros."""
    groups = _group_view(_np(mat), m)
    return bool(np.all((groups != 0).sum(1) <= n))


def create_mask_1d(mat, n, m):
    mat = _np(mat)
    groups = _group_view(np.abs(mat), m)
    # keep the n largest magnitudes per group
    idx = np.argsort(-groups, axis=1, kind='stable')[:, :n]
    mask = np.zeros_like(groups)
    np.put_along_axis(mask, idx, 1.0, axis=1)
    return mask.reshape(mat.shape)


def check_mask_2d(mat, n, m):
    """True iff every m×m block has ≤ n nonzeros per row AND per column."""
    arr = _np(mat)
    h, w = arr.shape[-2], arr.shape[-1]
    if h % m or w % m:
        raise ValueError('shape %s not divisible into %dx%d blocks'
                         % (arr.shape, m, m))
    a = arr.reshape(-1, h // m, m, w // m, m)
    nz = a != 0
    return bool(np.all(nz.sum(2) <= n) and np.all(nz.sum(4) <= n))


def create_mask_2d_greedy(mat, n, m):
    """Greedy 2D mask: per m×m block pick entries in decreasing magnitude
    subject to ≤ n per row and per column."""
    arr = _np(mat)
    h, w = arr.shape[-2], arr.shape[-1]
    if h % m or w % m:
        raise ValueError('shape %s not divisible into %dx%d blocks'
                         % (arr.shape, m, m))
    flat = arr.reshape(-1, h, w)
    mask = np.zeros_like(flat)
    for b in range(flat.shape[0]):
        for bi in range(0, h, m):
            for bj in range(0, w, m):
                block = np.abs(flat[b, bi:bi + m, bj:bj + m])
                order = np.dstack(np.unravel_index(
                    np.argsort(-block, axis=None), (m, m)))[0]
                rows = np.zeros(m, np.int64)
                cols = np.zeros(m, np.int64)
                for r, c in order:
                    if rows[r] < n and cols[c] < n:
                        mask[b, bi + r, bj + c] = 1.0
                        rows[r] += 1
                        cols[c] += 1
    return mask.reshape(arr.shape)


_MASK_FUNCS = {
    'mask_1d': create_mask_1d,
    'mask_2d_greedy': create_mask_2d_greedy,
    'mask_2d_best': create_mask_2d_greedy,  # greedy ≈ best for 2:4
}
_CHECK_FUNCS = {
    'check_1d': check_mask_1d,
    'check_2d': check_mask_2d,
}


def create_mask(mat, func_name='mask_1d', n=2, m=4):
    if func_name not in _MASK_FUNCS:
        raise ValueError('unknown mask func %r (have %s)'
                         % (func_name, sorted(_MASK_FUNCS)))
    return _MASK_FUNCS[func_name](_np(mat), n, m)


def check_sparsity(mat, func_name='check_1d', n=2, m=4):
    if func_name not in _CHECK_FUNCS:
        raise ValueError('unknown check func %r (have %s)'
                         % (func_name, sorted(_CHECK_FUNCS)))
    return _CHECK_FUNCS[func_name](_np(mat), n, m)


def set_excluded_layers(param_names):
    """Exclude parameters by name from pruning (reference
    sparsity.set_excluded_layers)."""
    _EXCLUDED.update(param_names)


def reset_excluded_layers():
    _EXCLUDED.clear()


def _prunable_params(model):
    from ..nn.layer.common import Linear
    from ..nn.layer.conv import Conv2D
    for lname, layer in model.named_modules():
        if lname and type(layer) in (Linear, Conv2D):
            w = layer.weight
            name = getattr(w, 'param_name', None) or (lname + '.weight')
            if name in _EXCLUDED or lname in _EXCLUDED:
                continue
            yield name, w


class ASPHelper:
    """Holds masks for a pruned model and re-applies them after optimizer
    steps (reference asp.py ASPHelper / OptimizerWithSparsityGuarantee)."""

    def __init__(self):
        self.masks = {}

    def prune_model(self, model, n=2, m=4, mask_algo='mask_1d',
                    with_mask=True):
        for name, w in _prunable_params(model):
            arr = _np(w)
            if arr.ndim < 2 or arr.shape[-1] % m:
                continue
            if arr.ndim > 2:
                # conv [out,in,kh,kw]: prune over the flattened (in*kh*kw)
                # per-out-channel view like the reference
                flat = arr.reshape(arr.shape[0], -1)
                if flat.shape[-1] % m:
                    continue
                mask = create_mask(flat, mask_algo, n, m).reshape(arr.shape)
            else:
                mask = create_mask(arr, mask_algo, n, m)
            mask = torch.as_tensor(mask, device=w.device).to(w.dtype)
            with torch.no_grad():
                w.mul_(mask)
            if with_mask:
                self.masks[id(w)] = (w, mask)
        return self.masks

    @torch.no_grad()
    def apply_masks(self):
        for w, mask in self.masks.values():
            w.mul_(mask)

    def decorate(self, optimizer):
        helper = self
        orig_step = optimizer.step

        def step(*args, **kwargs):
            out = orig_step(*args, **kwargs)
            helper.apply_masks()
            return out
        optimizer.step = step
        optimizer._asp_helper = helper
        return optimizer


_default_helper = ASPHelper()


def prune_model(model, n=2, m=4, mask_algo='mask_1d', with_mask=True):
    """Prune all Linear/Conv2D weights of `model` to n:m sparsity."""
    return _default_helper.prune_model(model, n=n, m=m,
                                       mask_algo=mask_algo,
                                       with_mask=with_mask)


def decorate(optimizer):
    """Wrap an optimizer so each step() re-applies the sparsity masks."""
    return _default_helper.decorate(optimizer)
