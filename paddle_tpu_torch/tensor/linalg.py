"""Linear algebra (counterpart of paddle_tpu/tensor/linalg.py)."""
import torch

from ._helpers import axes_arg, ensure_tensor
from .math import addmm, bmm, dot, matmul, mm, mv  # noqa: F401

__all__ = [
    'matmul', 'dot', 'mm', 'bmm', 'mv', 'addmm', 'norm', 'dist', 'cond',
    'cholesky', 'inv', 'det', 'slogdet', 'svd', 'qr', 'eig', 'eigh',
    'eigvals', 'eigvalsh', 'solve', 'triangular_solve', 'cholesky_solve',
    'lstsq', 'matrix_power', 'matrix_rank', 'pinv', 'cross', 'multi_dot',
    'histogram', 'bincount', 'corrcoef', 'cov', 'lu',
    'inverse', 't',
]


def norm(x, p='fro', axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    ax = axes_arg(axis)
    dims = tuple(range(x.dim())) if ax is None else ax
    if p == 'fro':
        return torch.sqrt(torch.sum(torch.square(x), dim=dims,
                                    keepdim=keepdim))
    a = torch.abs(x)
    if p in (float('inf'), 'inf'):
        return torch.amax(a, dim=dims, keepdim=keepdim)
    if p in (float('-inf'), '-inf'):
        return torch.amin(a, dim=dims, keepdim=keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), dim=dims, keepdim=keepdim)
    return torch.pow(torch.sum(torch.pow(a, p), dim=dims, keepdim=keepdim),
                     1.0 / p)


def dist(x, y, p=2, name=None):
    x = ensure_tensor(x)
    d = torch.abs(x - ensure_tensor(y, x))
    if p == 0:
        return torch.sum((d != 0).to(x.dtype))
    if p == float('inf'):
        return torch.amax(d)
    if p == float('-inf'):
        return torch.amin(d)
    return torch.pow(torch.sum(torch.pow(d, p)), 1.0 / p)


def cond(x, p=None, name=None):
    return torch.linalg.cond(ensure_tensor(x), p)


def cholesky(x, upper=False, name=None):
    return torch.linalg.cholesky(ensure_tensor(x), upper=upper)


def inv(x, name=None):
    return torch.linalg.inv(ensure_tensor(x))


def inverse(x, name=None):
    """inv under the reference's other name."""
    return inv(x)


def det(x, name=None):
    return torch.linalg.det(ensure_tensor(x))


def slogdet(x, name=None):
    """[sign, log |det|] stacked, as the JAX package returns them."""
    sign, logabs = torch.linalg.slogdet(ensure_tensor(x))
    return torch.stack([sign, logabs])


def svd(x, full_matrices=False, name=None):
    return tuple(torch.linalg.svd(ensure_tensor(x),
                                  full_matrices=full_matrices))


def qr(x, mode='reduced', name=None):
    x = ensure_tensor(x)
    if mode == 'r':
        return torch.linalg.qr(x, mode='r')[1]
    return tuple(torch.linalg.qr(x, mode=mode))


def eig(x, name=None):
    return tuple(torch.linalg.eig(ensure_tensor(x)))


def eigh(x, UPLO='L', name=None):
    return tuple(torch.linalg.eigh(ensure_tensor(x), UPLO=UPLO))


def eigvals(x, name=None):
    return torch.linalg.eigvals(ensure_tensor(x))


def eigvalsh(x, UPLO='L', name=None):
    return torch.linalg.eigvalsh(ensure_tensor(x), UPLO=UPLO)


def solve(x, y, name=None):
    x = ensure_tensor(x)
    return torch.linalg.solve(x, ensure_tensor(y, x))


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    a = ensure_tensor(x)
    if transpose:
        a, upper = a.transpose(-1, -2), not upper
    return torch.linalg.solve_triangular(a, ensure_tensor(y, a), upper=upper,
                                         unitriangular=unitriangular)


def cholesky_solve(x, y, upper=False, name=None):
    x = ensure_tensor(x)
    return torch.cholesky_solve(x, ensure_tensor(y, x), upper=upper)


def lstsq(x, y, rcond=None, driver=None, name=None):
    x = ensure_tensor(x)
    sol, res, rank, sv = torch.linalg.lstsq(x, ensure_tensor(y, x),
                                            rcond=rcond, driver='gelsd')
    return sol, res, rank, sv


def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(ensure_tensor(x), n)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    x = ensure_tensor(x)
    if tol is None:
        return torch.linalg.matrix_rank(x, hermitian=hermitian)
    return torch.linalg.matrix_rank(x, atol=tol, rtol=0.0,
                                    hermitian=hermitian)


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return torch.linalg.pinv(ensure_tensor(x), rtol=rcond,
                             hermitian=hermitian)


def cross(x, y, axis=9, name=None):
    """axis 9 (the reference's default): the first axis of size 3."""
    x = ensure_tensor(x)
    if axis == 9:
        axis = next(i for i, s in enumerate(x.shape) if s == 3)
    return torch.linalg.cross(x, ensure_tensor(y, x), dim=axis)


def multi_dot(x, name=None):
    return torch.linalg.multi_dot([ensure_tensor(t) for t in x])


def histogram(input, bins=100, min=0, max=0, name=None):
    """Counts (int64) of `bins` equal bins over [min, max], or over the
    data's range when both are 0."""
    a = ensure_tensor(input)
    lo, hi = (min, max) if (min != 0 or max != 0) else \
        (a.min().item(), a.max().item())
    return torch.histc(a.float(), bins, lo, hi).to(torch.int64)


def bincount(x, weights=None, minlength=0, name=None):
    x = ensure_tensor(x)
    w = None if weights is None else ensure_tensor(weights, x)
    return torch.bincount(x, w, minlength)


def corrcoef(x, rowvar=True, name=None):
    x = ensure_tensor(x)
    return torch.corrcoef(x if rowvar else x.t())


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    x = ensure_tensor(x)
    return torch.cov(x if rowvar else x.t(), correction=1 if ddof else 0,
                     fweights=fweights, aweights=aweights)


def lu(x, pivot=True, get_infos=False, name=None):
    """(LU packed, pivots 1-based int32[, infos]) of partial-pivoting LU."""
    if not pivot:
        raise NotImplementedError(
            'lu(pivot=False): partial-pivoting LU only, as in the JAX '
            'package')
    LU, piv = torch.linalg.lu_factor(ensure_tensor(x))
    outs = (LU, piv.to(torch.int32))
    if get_infos:
        return outs + (torch.zeros((), dtype=torch.int32,
                                   device=LU.device),)
    return outs


def t(input, name=None):
    """Transpose of a tensor of at most 2 dims."""
    x = ensure_tensor(input)
    if x.dim() > 2:
        raise ValueError('paddle.t only supports ndim <= 2, got %d'
                         % x.dim())
    return x.t() if x.dim() == 2 else x
