"""PS wire codec (counterpart of paddle_tpu/distributed/ps/wire.py, copied
whole: the same bytes on the wire).

Reference: distributed/service/sendrecv.proto — the brpc+protobuf frames.
A closed, typed binary format replaces pickle on the socket path:
unpickling attacker bytes is code execution by design, and a cross-host
parameter server must not offer that. Only these types
exist on the wire: None, bool, int, float, str, bytes, ndarray,
list/tuple, dict — decode can NEVER instantiate arbitrary objects.

Arrays ship as dtype + shape + raw buffer (zero-copy out of numpy), which
is also faster than pickling for the pull/push payloads that dominate.
"""
import struct

import numpy as np

__all__ = ['encode', 'decode']

_ALLOWED_DTYPES = {'float32', 'float64', 'float16', 'int8', 'int16',
                   'int32', 'int64', 'uint8', 'uint32', 'uint64', 'bool'}


def _enc(obj, out):
    if obj is None:
        out.append(b'N')
    elif obj is True:
        out.append(b'T')
    elif obj is False:
        out.append(b'F')
    elif isinstance(obj, int):
        out.append(b'i' + struct.pack('>q', obj))
    elif isinstance(obj, float):
        out.append(b'f' + struct.pack('>d', obj))
    elif isinstance(obj, str):
        b = obj.encode()
        out.append(b's' + struct.pack('>I', len(b)) + b)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(b'b' + struct.pack('>I', len(obj)) + bytes(obj))
    elif isinstance(obj, np.ndarray):
        dt = str(obj.dtype)
        if dt not in _ALLOWED_DTYPES:
            raise TypeError('dtype %s not allowed on the PS wire' % dt)
        a = np.ascontiguousarray(obj)
        dtb = dt.encode()
        out.append(b'a' + bytes([len(dtb)]) + dtb +
                   bytes([a.ndim]) + struct.pack('>%dq' % a.ndim, *a.shape))
        out.append(a.tobytes())
    elif isinstance(obj, np.generic):
        _enc(obj.item(), out)
    elif isinstance(obj, (list, tuple)):
        tag = b'l' if isinstance(obj, list) else b't'
        out.append(tag + struct.pack('>I', len(obj)))
        for v in obj:
            _enc(v, out)
    elif isinstance(obj, dict):
        out.append(b'd' + struct.pack('>I', len(obj)))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError('PS wire dict keys must be str, got %r' % k)
            _enc(k, out)
            _enc(v, out)
    else:
        raise TypeError('type %s not allowed on the PS wire' % type(obj))


def encode(obj):
    out = []
    _enc(obj, out)
    return b''.join(out)


class _Reader:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.buf):
            raise ValueError('truncated PS wire message')
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b


def _dec(r):
    tag = r.take(1)
    if tag == b'N':
        return None
    if tag == b'T':
        return True
    if tag == b'F':
        return False
    if tag == b'i':
        return struct.unpack('>q', r.take(8))[0]
    if tag == b'f':
        return struct.unpack('>d', r.take(8))[0]
    if tag == b's':
        n = struct.unpack('>I', r.take(4))[0]
        return r.take(n).decode()
    if tag == b'b':
        n = struct.unpack('>I', r.take(4))[0]
        return bytes(r.take(n))
    if tag == b'a':
        dtn = r.take(1)[0]
        dt = r.take(dtn).decode()
        if dt not in _ALLOWED_DTYPES:
            raise ValueError('dtype %s not allowed on the PS wire' % dt)
        ndim = r.take(1)[0]
        shape = struct.unpack('>%dq' % ndim, r.take(8 * ndim)) if ndim \
            else ()
        count = 1
        for s in shape:
            if s < 0:
                raise ValueError('negative dim on the PS wire')
            count *= s
        raw = r.take(count * np.dtype(dt).itemsize)
        return np.frombuffer(raw, dtype=dt).reshape(shape).copy()
    if tag in (b'l', b't'):
        n = struct.unpack('>I', r.take(4))[0]
        items = [_dec(r) for _ in range(n)]
        return items if tag == b'l' else tuple(items)
    if tag == b'd':
        n = struct.unpack('>I', r.take(4))[0]
        out = {}
        for _ in range(n):
            k = _dec(r)
            if not isinstance(k, str):
                raise ValueError('non-str dict key on the PS wire')
            out[k] = _dec(r)
        return out
    raise ValueError('unknown PS wire tag %r' % tag)


def decode(buf):
    r = _Reader(buf)
    obj = _dec(r)
    if r.pos != len(buf):
        raise ValueError('trailing bytes in PS wire message')
    return obj
