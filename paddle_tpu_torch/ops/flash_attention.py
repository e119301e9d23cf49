"""Flash attention on Hopper (counterpart of paddle_tpu/ops/flash_attention.py).

Forward: `flash_fwd_cuda` launches the hand-written CUDA kernel
csrc/flash_fwd.cu, which replaces the TPU Pallas kernel `_fwd_kernel`.
`forward` is the split interface `(q, k, v, causal, scale) -> (o, lse)`.

Backward: csrc/flash_bwd.cu replaces the three Pallas kernels of the
standard path. `flash_bwd_fused_cuda` computes dq, dk and dv in one pass
(`_bwd_fused_kernel`); `flash_bwd_dq_cuda` and `flash_bwd_dkv_cuda` are
the two-pass pair (`_bwd_dq_kernel`, `_bwd_dkv_kernel`). `backward` is the
split interface `(q, k, v, o, lse, do, causal, scale) -> (dq, dk, dv)`
and routes as the JAX package's `_bwd_impl` does at its default blocks.

Long sequences (max(n, m) >= LONG_SEQ) take the long route, as the JAX
package's `_use_long_path` does: `flash_fwd_long_cuda` (csrc/flash_fwd.cu,
replacing `_fwd_kernel_long`), then in the backward `flash_bwd_dq_long_cuda`
and `flash_bwd_dkv_long_cuda` (csrc/flash_bwd.cu, replacing
`_bwd_dq_kernel_long` and `_bwd_dkv_kernel_long`); the long route has no
fused backward. Its entry points launch the same kernels as the standard
ones: on the H100 one tiling serves every length (the sources' headers
say why), so the route differs only in the backward's passes and counts.

Every kernel wrapper launches its kernel for CUDA tensors or raises: it
never falls back. For CPU tensors the split interfaces take the plain
versions `flash_attention_fwd_ref` / `flash_attention_bwd_ref`, which
follow the kernels' numeric contract on both routes. `flash_attention_bnhd`
/ `_bhnd` are the public entry points; their autograd Function saves q, k,
v, o and lse and runs `backward`.

Routing follows the JAX package's `_dispatch_fwd`: causal attention with
n != m is not the kernels' contract (they are top-left causal) and goes to
the bottom-right blockwise attention (ops/blockwise_attention.py) before
any kernel; a shape `_supported` rejects goes to the plain attention
`_ref_bhnd` before any launch, is counted, and raises under
PADDLE_TPU_FLASH_STRICT=1.
"""
import ctypes
import math
import os

import torch

from .. import _build
from .blockwise_attention import blockwise_attention_bnhd

_NEG_INF = -1e30
# the kernel's template instantiations (csrc/flash_fwd.cu)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_KERNEL_HEAD_DIMS = (64, 128)

# The JAX package's backward runs one fused kernel when one 512 x 512 block
# covers the score matrix (`_bwd_impl` at the default blocks, _fit_block),
# else the dq and dk/dv pair. 512 is the TPU's tuning; it is kept so the
# port takes the same route, and is to be re-measured on the H100.
FUSED_BWD_MAX_SEQ = 512

# The JAX package sends max(n, m) >= 4096 to its long kernels
# (flash_defaults.LONG_SEQ). 4096 is the TPU's tuning, where the standard
# kernels ran out of VMEM; it is kept so the port takes the same route. On
# the H100 both routes launch the same kernels, so above FUSED_BWD_MAX_SEQ
# the threshold moves no time.
LONG_SEQ = 4096

# Calls by route, on either device (the kernel on CUDA, its plain version
# on CPU). Forward: 'flash' (standard) and 'fwd_long'; backward:
# 'bwd_fused', 'bwd_two_pass' and 'bwd_long'. 'rejected': calls _supported
# routed to _ref_bhnd; 'blockwise': causal n != m calls routed to the
# blockwise attention.
counts = {'flash': 0, 'fwd_long': 0, 'rejected': 0, 'blockwise': 0,
          'bwd_fused': 0, 'bwd_two_pass': 0, 'bwd_long': 0}


def _use_long_path(n, m):
    return max(n, m) >= LONG_SEQ


def _check_causal_lengths(causal, n, m):
    if causal and n != m:
        raise ValueError(
            'the flash kernels are top-left causal with n == m; got n=%d, '
            'm=%d (flash_attention_bnhd routes cross-length causal to the '
            'blockwise attention)' % (n, m))


def strict_mode():
    """PADDLE_TPU_FLASH_STRICT=1: a shape the kernel cannot take raises
    instead of running the plain attention."""
    return os.environ.get('PADDLE_TPU_FLASH_STRICT', '0') == '1'


def _supported(q, k, v):
    """None if the flash kernel can run on these operands, else the reason."""
    d = q.shape[-1]
    if not (q.dtype == k.dtype == v.dtype):
        return 'mixed operand dtypes (%s, %s, %s)' % (q.dtype, k.dtype,
                                                      v.dtype)
    if d % 64:
        return 'head_dim %d %% 64 != 0' % d
    if d not in _KERNEL_HEAD_DIMS:
        return 'head_dim %d has no kernel instantiation %s' % (
            d, _KERNEL_HEAD_DIMS)
    if q.dtype not in _KERNEL_DTYPES:
        return 'dtype %s has no kernel instantiation' % q.dtype
    if q.shape[2] == 0 or k.shape[2] == 0:
        return 'empty sequence'
    return None


def _ref_bhnd(q, k, v, causal, scale):
    """Plain attention: bottom-right causal, softmax in f32."""
    dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        n, m = s.shape[-2], s.shape[-1]
        if n > m:
            raise ValueError(
                'causal attention with more queries (%d) than keys (%d)'
                % (n, m))
        keep = torch.ones(n, m, dtype=torch.bool, device=s.device).tril(m - n)
        s = s.masked_fill(~keep, max(_NEG_INF, torch.finfo(s.dtype).min))
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.matmul(p, v)


def flash_attention_fwd_ref(q, k, v, causal, scale):
    """The forward kernels' plain version, for the standard and the long
    route alike (they compute one function under one numeric contract).

    q [b, h, n, d], k/v [b, h, m, d] of one dtype. Products of the native
    operands summed in f32, top-left causal masking, softmax in f32, p cast
    to v's dtype before p @ v. Returns o in q's dtype and lse = m + log(l)
    as f32 [b, h, n, 1]."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        n, m = s.shape[-2], s.shape[-1]
        keep = torch.ones(n, m, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    mx = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - mx)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l_safe
    return o.to(q.dtype), mx + torch.log(l_safe)


def _fwd_lib():
    lib = _build.load('flash_fwd')
    for name in ('flash_fwd', 'flash_fwd_long'):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = (
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 +
                [ctypes.c_longlong] * 12 +
                [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    if lib.flash_fwd_error_string.argtypes is None:
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
        lib.flash_fwd_error_string.argtypes = [ctypes.c_int]
    return lib


def _rows_aligned(t):
    """t itself if its rows are contiguous and its base and (b, h, row)
    strides are multiples of 16 bytes, else an aligned copy. The 16-bit
    kernels read their operands through TMA tensor maps, which need both;
    the q/k/v views of a packed [b, n, 3, h, d] projection pass as they
    are."""
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and \
            all(s * t.element_size() % 16 == 0 for s in t.stride()[:3]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _fwd_launch(entry, q, k, v, causal, scale):
    """Check what the forward kernel `entry` takes, launch it; (o, lse)."""
    name = entry + '_cuda'
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError('%s takes CUDA tensors' % name)
    if not (q.device == k.device == v.device):
        raise ValueError('q, k, v on different devices')
    reason = _supported(q, k, v)
    if reason is not None:
        raise ValueError('%s cannot run: %s' % (name, reason))
    b, h, n, d = q.shape
    m = k.shape[2]
    if k.shape != (b, h, m, d) or v.shape != k.shape:
        raise ValueError('shape mismatch: q %s, k %s, v %s'
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    _check_causal_lengths(causal, n, m)
    q, k, v = (_rows_aligned(t) for t in (q, k, v))
    # o is laid out [b, n, h, d] in memory: the callers read it back in
    # that layout, so the swap to [b, h, n, d] and back costs no copy
    o = torch.empty((b, n, h, d), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, n, 1), dtype=torch.float32, device=q.device)
    lib = _fwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), _KERNEL_DTYPES[q.dtype], b, h, n, m, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], float(scale), int(bool(causal)), stream)
    if err != 0:
        raise RuntimeError('%s launch failed: %s (cuda error %d)' % (
            entry, lib.flash_fwd_error_string(err).decode(), err))
    return o, lse


def flash_fwd_cuda(q, k, v, causal, scale):
    """Launch csrc/flash_fwd.cu on CUDA tensors q [b, h, n, d] and k/v
    [b, h, m, d]; returns (o, lse). Raises on anything the kernel does not
    take. `flash_fwd_cuda.launches` counts the launches."""
    out = _fwd_launch('flash_fwd', q, k, v, causal, scale)
    flash_fwd_cuda.launches += 1
    return out


def flash_fwd_long_cuda(q, k, v, causal, scale):
    """Launch the long route's forward, csrc/flash_fwd.cu's flash_fwd_long
    (the same kernels as flash_fwd); the arguments, checks and result of
    flash_fwd_cuda. `flash_fwd_long_cuda.launches` counts the launches."""
    out = _fwd_launch('flash_fwd_long', q, k, v, causal, scale)
    flash_fwd_long_cuda.launches += 1
    return out


flash_fwd_cuda.launches = 0
flash_fwd_long_cuda.launches = 0


def forward(q, k, v, causal, scale):
    """Split interface: (o, lse) with lse f32 [b, h, n, 1]. The standard or
    the long kernel for CUDA tensors, by length; the plain version for CPU
    tensors."""
    n, m = q.shape[2], k.shape[2]
    _check_causal_lengths(causal, n, m)
    long_path = _use_long_path(n, m)
    counts['fwd_long' if long_path else 'flash'] += 1
    if q.is_cuda:
        kernel = flash_fwd_long_cuda if long_path else flash_fwd_cuda
        return kernel(q, k, v, causal, scale)
    if q.device.type != 'cpu' or k.device != q.device or v.device != q.device:
        raise ValueError('flash forward takes CUDA tensors or CPU tensors, '
                         'all on one device; got %s, %s, %s'
                         % (q.device, k.device, v.device))
    return flash_attention_fwd_ref(q, k, v, causal, scale)


def flash_attention_bwd_ref(q, k, v, do, lse, delta, causal, scale):
    """The backward kernels' plain version: one function for all five
    (fused, dq and dk/dv of the standard route; dq and dk/dv of the long
    route).

    q, do [b, h, n, d] and k, v [b, h, m, d] of one dtype; lse and
    delta = rowsum(do * o) f32 [b, h, n, 1]. The TPU kernels' contract:
    products of the native operands summed in f32, top-left causal
    masking, p = exp(min(s - lse, 30)), ds = p * (dp - delta) * scale,
    and p / ds cast to the operand dtype before the products they feed.
    Returns (dq, dk, dv) in the operands' dtype."""
    dt = q.dtype
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        n, m = s.shape[-2], s.shape[-1]
        keep = torch.ones(n, m, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    p = torch.exp(torch.clamp_max(s - lse, 30.0))
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta) * scale).to(dt).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _bwd_lib():
    lib = _build.load('flash_bwd')
    for name in ('flash_bwd_fused', 'flash_bwd_dq', 'flash_bwd_dkv',
                 'flash_bwd_dq_long', 'flash_bwd_dkv_long'):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 +
                           [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                            ctypes.c_void_p])
    if lib.flash_bwd_error_string.argtypes is None:
        lib.flash_bwd_error_string.restype = ctypes.c_char_p
        lib.flash_bwd_error_string.argtypes = [ctypes.c_int]
    return lib


def _bwd_operands(name, q, k, v, do, lse, delta, causal):
    """Check what a backward kernel takes; returns the operands as the
    kernel reads them and (b, h, n, m, d)."""
    ops = (q, k, v, do, lse, delta)
    if not all(t.is_cuda for t in ops):
        raise ValueError('%s takes CUDA tensors' % name)
    if any(t.device != q.device for t in ops):
        raise ValueError('%s: operands on different devices' % name)
    reason = _supported(q, k, v)
    if reason is not None:
        raise ValueError('%s cannot run: %s' % (name, reason))
    b, h, n, d = q.shape
    m = k.shape[2]
    if k.shape != (b, h, m, d) or v.shape != k.shape or do.shape != q.shape:
        raise ValueError('shape mismatch: q %s, k %s, v %s, do %s' % (
            tuple(q.shape), tuple(k.shape), tuple(v.shape), tuple(do.shape)))
    if do.dtype != q.dtype:
        raise ValueError('do is %s, the operands %s' % (do.dtype, q.dtype))
    for label, t in (('lse', lse), ('delta', delta)):
        if t.shape != (b, h, n, 1) or t.dtype != torch.float32:
            raise ValueError('%s must be float32 %s, got %s %s' % (
                label, (b, h, n, 1), t.dtype, tuple(t.shape)))
    _check_causal_lengths(causal, n, m)
    # lse and delta are indexed as dense [b, h, n] rows
    return ([_rows_aligned(t) for t in (q, k, v, do)] +
            [lse.contiguous(), delta.contiguous()], (b, h, n, m, d))


def _grad_like(b, rows, h, d, dtype, device):
    """A [b, h, rows, d] gradient laid out [b, rows, h, d] in memory, the
    layout the [B, N, H, D] callers take it back in."""
    return torch.empty((b, rows, h, d), dtype=dtype,
                       device=device).transpose(1, 2)


def _bwd_launch(entry, operands, dims, outs, ds, scale, causal):
    q, k, v, do, lse, delta = operands
    dq, dk, dv = outs
    b, h, n, m, d = dims
    strides = []
    for t in (q, k, v, do, dq, dk, dv):
        strides += list(t.stride()[:3]) if t is not None else [0, 0, 0]
    strides = (ctypes.c_longlong * len(strides))(*strides)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, entry)(
            ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), ptr(dq),
            ptr(dk), ptr(dv), ptr(ds), _KERNEL_DTYPES[q.dtype], b, h, n,
            m, d, ctypes.cast(strides, ctypes.c_void_p), float(scale),
            int(bool(causal)), stream)
    if err != 0:
        raise RuntimeError('%s launch failed: %s (cuda error %d)' % (
            entry, lib.flash_bwd_error_string(err).decode(), err))


def flash_bwd_fused_cuda(q, k, v, do, lse, delta, causal, scale):
    """Launch the fused backward of csrc/flash_bwd.cu: (dq, dk, dv) from
    one computation of s, p and dp per tile pair. Its two kernels pass ds^T
    through a [b, h, m, n rounded up to 64] workspace, and dq is summed in
    a fixed order, so it is deterministic. `flash_bwd_fused_cuda.launches`
    counts launches."""
    operands, dims = _bwd_operands('flash_bwd_fused_cuda', q, k, v, do, lse,
                                   delta, causal)
    b, h, n, m, d = dims
    outs = (_grad_like(b, n, h, d, q.dtype, q.device),
            _grad_like(b, m, h, d, q.dtype, q.device),
            _grad_like(b, m, h, d, q.dtype, q.device))
    ds = torch.empty((b, h, m, -(-n // 64) * 64), dtype=q.dtype,
                     device=q.device)
    _bwd_launch('flash_bwd_fused', operands, dims, outs, ds, scale, causal)
    flash_bwd_fused_cuda.launches += 1
    return outs


def _bwd_dq(entry, q, k, v, do, lse, delta, causal, scale):
    operands, dims = _bwd_operands(entry + '_cuda', q, k, v, do, lse, delta,
                                   causal)
    b, h, n, m, d = dims
    dq = _grad_like(b, n, h, d, q.dtype, q.device)
    _bwd_launch(entry, operands, dims, (dq, None, None), None, scale, causal)
    return dq


def _bwd_dkv(entry, q, k, v, do, lse, delta, causal, scale):
    operands, dims = _bwd_operands(entry + '_cuda', q, k, v, do, lse, delta,
                                   causal)
    b, h, n, m, d = dims
    dk = _grad_like(b, m, h, d, q.dtype, q.device)
    dv = _grad_like(b, m, h, d, q.dtype, q.device)
    _bwd_launch(entry, operands, dims, (None, dk, dv), None, scale, causal)
    return dk, dv


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale):
    """Launch the dq pass of csrc/flash_bwd.cu; returns dq."""
    dq = _bwd_dq('flash_bwd_dq', q, k, v, do, lse, delta, causal, scale)
    flash_bwd_dq_cuda.launches += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale):
    """Launch the dk/dv pass of csrc/flash_bwd.cu; returns (dk, dv)."""
    out = _bwd_dkv('flash_bwd_dkv', q, k, v, do, lse, delta, causal, scale)
    flash_bwd_dkv_cuda.launches += 1
    return out


def flash_bwd_dq_long_cuda(q, k, v, do, lse, delta, causal, scale):
    """Launch the long route's dq pass, csrc/flash_bwd.cu's
    flash_bwd_dq_long (the same kernel as flash_bwd_dq); returns dq."""
    dq = _bwd_dq('flash_bwd_dq_long', q, k, v, do, lse, delta, causal, scale)
    flash_bwd_dq_long_cuda.launches += 1
    return dq


def flash_bwd_dkv_long_cuda(q, k, v, do, lse, delta, causal, scale):
    """Launch the long route's dk/dv pass, csrc/flash_bwd.cu's
    flash_bwd_dkv_long (the same kernel as flash_bwd_dkv); returns
    (dk, dv)."""
    out = _bwd_dkv('flash_bwd_dkv_long', q, k, v, do, lse, delta, causal,
                   scale)
    flash_bwd_dkv_long_cuda.launches += 1
    return out


for _wrapper in (flash_bwd_fused_cuda, flash_bwd_dq_cuda, flash_bwd_dkv_cuda,
                 flash_bwd_dq_long_cuda, flash_bwd_dkv_long_cuda):
    _wrapper.launches = 0


def backward(q, k, v, o, lse, do, causal, scale):
    """Split interface: (dq, dk, dv) of o = attention(q, k, v) given lse
    and the output gradient do. delta = rowsum(do * o) is a plain f32
    reduction, as in the JAX package. The long route (max(n, m) >=
    LONG_SEQ) runs the long dq then dk/dv kernels; below it, fused when
    max(n, m) <= FUSED_BWD_MAX_SEQ, else dq then dk/dv. The kernels for
    CUDA tensors, the plain version for CPU tensors."""
    n, m = q.shape[2], k.shape[2]
    _check_causal_lengths(causal, n, m)
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    if _use_long_path(n, m):
        route = 'bwd_long'
    elif max(n, m) <= FUSED_BWD_MAX_SEQ:
        route = 'bwd_fused'
    else:
        route = 'bwd_two_pass'
    counts[route] += 1
    if q.is_cuda:
        args = (q, k, v, do, lse, delta, causal, scale)
        if route == 'bwd_fused':
            return flash_bwd_fused_cuda(*args)
        if route == 'bwd_long':
            return (flash_bwd_dq_long_cuda(*args),
                    *flash_bwd_dkv_long_cuda(*args))
        return flash_bwd_dq_cuda(*args), *flash_bwd_dkv_cuda(*args)
    if any(t.device.type != 'cpu' for t in (k, v, o, lse, do)):
        raise ValueError('flash backward takes CUDA tensors or CPU tensors, '
                         'all on one device')
    return flash_attention_bwd_ref(q, k, v, do, lse, delta, causal, scale)


class _FlashForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = backward(q, k, v, o, lse, do, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def _dispatch_fwd(q, k, v, causal, scale):
    """Returns (o, lse_or_None); lse None means the flash kernels did not
    run (the blockwise or the plain attention did)."""
    if causal and q.shape[2] != k.shape[2]:
        # bottom-right causal (a query chunk over a longer cache) is the
        # blockwise attention's contract, not the kernels': a semantics
        # route, not a capability fallback, so strict mode does not apply
        counts['blockwise'] += 1
        return blockwise_attention_bnhd(q, k, v, causal=True,
                                        scale=scale), None
    reason = _supported(q, k, v)
    if reason is not None:
        counts['rejected'] += 1
        if strict_mode():
            raise RuntimeError(
                'PADDLE_TPU_FLASH_STRICT=1 but the flash kernel cannot '
                'run: ' + reason)
        return _ref_bhnd(q, k, v, causal, scale), None
    return _FlashForward.apply(q, k, v, causal, scale)


def flash_attention_bnhd(q, k, v, causal=False, scale=None):
    """Paddle layout [B, N, H, D] in and out."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    o, _ = _dispatch_fwd(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal, scale)
    return o.transpose(1, 2)


def flash_attention_bhnd(q, k, v, causal=False, scale=None):
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _dispatch_fwd(q, k, v, causal, scale)[0]
