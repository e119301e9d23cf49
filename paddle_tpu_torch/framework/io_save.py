"""save / load with a CRC manifest (counterpart of
paddle_tpu/framework/io_save.py).

Format: a pickled nested structure whose tensor leaves are the port's own
`_TensorPayload` (a numpy array plus a dtype tag); load gives torch tensors
back (numpy arrays with return_numpy=True). The JAX package pickles its own
payload class, so the two packages' artifacts are not byte-identical and
their fingerprints differ; neither reads the other's files.

16-bit floats: numpy has no bfloat16 without ml_dtypes, so every bf16 / fp16
tensor is stored as its raw uint16 view beside its dtype tag and comes back
bit for bit. With return_numpy=True a bf16 tensor comes back as float32
(exact: each bf16 value is an f32 value).

Durability: every save is atomic (write-to-temp + fsync + rename, so a
writer preempted mid-save never tears the previous snapshot) and carries
a CRC32 manifest sidecar (`<path>.manifest`) that load verifies before
unpickling — a truncated or bit-flipped file surfaces as
CheckpointCorruptError instead of a confusing UnpicklingError (or, worse,
silently wrong tensors). Files without a manifest load as before (legacy
snapshots, foreign files).

Encryption: save(..., encryption_key=k) writes the pickle inside a
PTCRYPT1 container (framework/crypto.py: AES-256-GCM, or the HMAC-CTR
fallback); the manifest vouches for the container's bytes. load of an
encrypted file needs the key: without it, or with a wrong one, it raises
ValueError.
"""
import json
import os
import pickle
import zlib

import numpy as np
import torch

from . import crypto

__all__ = ['save', 'load', 'CheckpointCorruptError', 'manifest_path',
           'verify_checkpoint', 'write_bytes_atomic']

_PROTOCOL = 4
_MANIFEST_FORMAT = 1

# Write-path fault hooks (same shape as distributed/resilience.py's
# transport hooks): testing/chaos.py installs injectors here to crash a
# save at a named point and prove the torn states a preempted writer can
# leave behind. Points, in write order:
#   'pre_rename'   — payload in the temp file, not yet renamed into place
#   'pre_manifest' — payload renamed, manifest sidecar not yet written
_FAULT_HOOKS = []

# 16-bit float types stored as their raw uint16 bits
_BITS16 = {'bfloat16': torch.bfloat16, 'float16': torch.float16}


def _fire(point, path):
    for hook in list(_FAULT_HOOKS):
        hook(point, path)


class CheckpointCorruptError(IOError):
    """The file's bytes do not match its manifest (truncated / torn /
    bit-flipped snapshot)."""


class _TensorPayload:
    """A tensor as numpy bits: `array` holds the values, or for bf16 /
    fp16 their uint16 view; `dtype` names the torch dtype."""

    def __init__(self, array, dtype, kind, requires_grad):
        self.array = array
        self.dtype = dtype
        self.kind = kind
        self.requires_grad = requires_grad


def _to_saveable(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous()
        name = str(t.dtype).replace('torch.', '')
        arr = t.view(torch.int16).numpy().view(np.uint16).copy() \
            if name in _BITS16 else t.numpy().copy()
        kind = 'Parameter' if isinstance(obj, torch.nn.Parameter) \
            else 'Tensor'
        return _TensorPayload(arr, name, kind, bool(obj.requires_grad))
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = type(obj)
        return t(_to_saveable(v) for v in obj)
    return obj


def _payload_tensor(p):
    if p.dtype in _BITS16:
        bits = torch.from_numpy(np.ascontiguousarray(p.array)
                                .view(np.int16))
        return bits.view(_BITS16[p.dtype])
    return torch.from_numpy(np.ascontiguousarray(p.array))


def _from_saveable(obj, return_numpy=False):
    if isinstance(obj, _TensorPayload):
        t = _payload_tensor(obj)
        if return_numpy:
            return t.float().numpy() if obj.dtype == 'bfloat16' \
                else t.numpy()
        if obj.kind == 'Parameter':
            return torch.nn.Parameter(t, requires_grad=obj.requires_grad)
        return t.requires_grad_(obj.requires_grad) \
            if t.is_floating_point() else t
    if isinstance(obj, dict):
        return {k: _from_saveable(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = type(obj)
        return t(_from_saveable(v, return_numpy) for v in obj)
    return obj


def manifest_path(path):
    return path + '.manifest'


def _write_atomic(path, data):
    """Write bytes to a same-directory temp file, fsync, rename into
    place — a concurrent reader (or a preempted writer) never observes a
    half-written file at `path`."""
    tmp = '%s.tmp.%d' % (path, os.getpid())
    with open(tmp, 'wb') as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_bytes_atomic(path, data):
    """Public door to the atomic byte-writer for small non-pickle
    artifacts that ride next to data files (shard index sidecars,
    JSON manifests): same write-temp + fsync + rename discipline as
    save(), so readers never observe a torn sidecar."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    _write_atomic(path, data)


def save(obj, path, protocol=_PROTOCOL, **configs):
    """configs: encryption_key=... writes an AES-GCM (or HMAC-CTR
    fallback) PTCRYPT1 container (reference framework/io/crypto
    encrypted save)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    key = configs.get('encryption_key')
    payload = pickle.dumps(_to_saveable(obj), protocol=protocol)
    if key is not None:
        payload = crypto.encrypt(payload, key)
    manifest = json.dumps({'format': _MANIFEST_FORMAT,
                           'size': len(payload),
                           'crc32': zlib.crc32(payload) & 0xFFFFFFFF})
    # data first, then manifest: a crash between the two renames leaves a
    # stale (or missing) manifest whose mismatch reads as "corrupt" —
    # restore then falls back to an older snapshot, the conservative
    # outcome. The _fire points let chaos tests crash at each boundary.
    tmp = '%s.tmp.%d' % (path, os.getpid())
    with open(tmp, 'wb') as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    _fire('pre_rename', path)
    os.replace(tmp, path)
    _fire('pre_manifest', path)
    _write_atomic(manifest_path(path), manifest.encode())


def _check_manifest(path, payload):
    """Raise CheckpointCorruptError if `path` has a manifest that does
    not vouch for `payload`. Missing/unreadable manifest = legacy file,
    accepted as-is."""
    try:
        with open(manifest_path(path)) as f:
            m = json.load(f)
    except (OSError, ValueError):
        return
    if m.get('size') != len(payload) or \
            m.get('crc32') != (zlib.crc32(payload) & 0xFFFFFFFF):
        raise CheckpointCorruptError(
            '%s does not match its manifest (size %d vs %s) — truncated '
            'or torn snapshot' % (path, len(payload), m.get('size')))


def verify_checkpoint(path, require_manifest=False):
    """True iff `path` exists and its bytes match its manifest (or it has
    no manifest to check against). With require_manifest=True a missing
    manifest fails the check: a bare data file means the writer died
    between rename and manifest — a torn state to fall back from, not a
    legacy file to trust."""
    try:
        with open(path, 'rb') as f:
            payload = f.read()
        if require_manifest and not os.path.exists(manifest_path(path)):
            return False
        _check_manifest(path, payload)
        return True
    except (OSError, CheckpointCorruptError):
        return False


def load(path, **configs):
    return_numpy = configs.get('return_numpy', False)
    key = configs.get('encryption_key')
    with open(path, 'rb') as f:
        payload = f.read()
    _check_manifest(path, payload)
    if payload.startswith(crypto._MAGIC):
        if key is None:
            raise ValueError(
                '%s is encrypted — pass encryption_key= to paddle.load'
                % path)
        payload = crypto.decrypt(payload, key)
    obj = pickle.loads(payload)
    return _from_saveable(obj, return_numpy)
