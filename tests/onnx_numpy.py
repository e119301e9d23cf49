"""A jax-free ONNX reader and numpy evaluator, shared by
tests/test_torch_onnx.py and chip_smoke.py's phase 32.

The reader and the evaluator are tests/test_onnx.py's (the JAX package
ships no ONNX runtime, and no onnx package is installed), with:
- zero-copy parsing over a memoryview, for files of hundreds of MB;
- signed INT attributes;
- the ops the two exporters write beyond test_onnx.py's set: Conv,
  MaxPool and AveragePool (LeNet), Not / And / Or, Floor / Ceil / Sign,
  ArgMax, Mod, ReduceProd, Pad, IsInf / IsNaN.

`run_onnx(blob, feeds)` returns the graph's outputs in order;
`parse_model(blob)` returns (nodes, initializers, input names, output
names), each node as (op_type, inputs, outputs, attrs).
"""
import struct

import numpy as np


# -- minimal ONNX protobuf reader -------------------------------------------

def _read_varint(buf, pos):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _signed(v):
    return v - (1 << 64) if v >= 1 << 63 else v


def _fields(buf):
    buf = memoryview(buf)
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = bytes(buf[pos:pos + 4])
            pos += 4
        else:
            raise ValueError('wire %d' % wire)
        yield field, wire, val


NP_OF_ONNX = {1: np.float32, 6: np.int32, 7: np.int64, 9: np.bool_,
              10: np.float16, 11: np.float64, 2: np.uint8, 3: np.int8,
              5: np.int16, 12: np.uint32, 13: np.uint64}


def _parse_tensor(buf):
    dims, dtype, raw, name = [], 1, b'', ''
    for f, w, v in _fields(buf):
        if f == 1:
            dims.append(v)
        elif f == 2:
            dtype = v
        elif f == 8:
            name = bytes(v).decode()
        elif f == 9:
            raw = v
    arr = np.frombuffer(raw, dtype=NP_OF_ONNX[dtype]).reshape(dims).copy()
    return name, arr


def _parse_attr(buf):
    name, atype = '', None
    ival = fval = sval = None
    ints = []
    for f, w, v in _fields(buf):
        if f == 1:
            name = bytes(v).decode()
        elif f == 20:
            atype = v
        elif f == 3:
            ival = _signed(v)
        elif f == 2:
            fval = struct.unpack('<f', v)[0]
        elif f == 4:
            sval = bytes(v).decode()
        elif f == 8:
            # packed ints
            p = 0
            while p < len(v):
                x, p = _read_varint(v, p)
                ints.append(_signed(x))
    if atype == 7:
        return name, ints
    if atype == 2:
        return name, ival
    if atype == 1:
        return name, fval
    if atype == 3:
        return name, sval
    return name, ints or ival or fval or sval


def _parse_node(buf):
    ins, outs, op, attrs = [], [], '', {}
    for f, w, v in _fields(buf):
        if f == 1:
            ins.append(bytes(v).decode())
        elif f == 2:
            outs.append(bytes(v).decode())
        elif f == 4:
            op = bytes(v).decode()
        elif f == 5:
            k, val = _parse_attr(v)
            attrs[k] = val
    return op, ins, outs, attrs


def parse_model(blob):
    graph = None
    for f, w, v in _fields(blob):
        if f == 7:
            graph = v
    assert graph is not None, 'ModelProto.graph missing'
    nodes, inits, g_in, g_out = [], {}, [], []
    for f, w, v in _fields(graph):
        if f == 1:
            nodes.append(_parse_node(v))
        elif f == 5:
            name, arr = _parse_tensor(v)
            inits[name] = arr
        elif f == 11:
            for f2, w2, v2 in _fields(v):
                if f2 == 1:
                    g_in.append(bytes(v2).decode())
        elif f == 12:
            for f2, w2, v2 in _fields(v):
                if f2 == 1:
                    g_out.append(bytes(v2).decode())
    return nodes, inits, g_in, g_out


# -- numpy evaluator ---------------------------------------------------------

def _windows(x, kernel, strides, pads, fill, ceil_mode=0):
    """x [N, C, *spatial] padded with `fill`; yields (out index, window
    view) per kernel offset as strided slices: out = reduce over them."""
    sp = x.ndim - 2
    lo, hi = pads[:sp], pads[sp:]
    xp = np.pad(x, [(0, 0), (0, 0)] + list(zip(lo, hi)),
                constant_values=fill)
    out = []
    for d in range(sp):
        span = xp.shape[2 + d] - kernel[d]
        n = (-(-span // strides[d]) if ceil_mode else span // strides[d]) + 1
        out.append(n)
    need = [(o - 1) * s + k for o, s, k in zip(out, strides, kernel)]
    if any(nd > xp.shape[2 + d] for d, nd in enumerate(need)):
        xp = np.pad(xp, [(0, 0), (0, 0)] + [
            (0, max(0, nd - xp.shape[2 + d])) for d, nd in enumerate(need)],
            constant_values=fill)
    offsets = np.stack(np.meshgrid(*[np.arange(k) for k in kernel],
                                   indexing='ij'), -1).reshape(-1, sp)
    for off in offsets:
        sl = tuple(slice(int(o), int(o) + (n - 1) * s + 1, s)
                   for o, n, s in zip(off, out, strides))
        yield off, xp[(slice(None), slice(None)) + sl]


def _conv(x, w, b, attrs):
    sp = x.ndim - 2
    strides = attrs.get('strides', [1] * sp)
    dil = attrs.get('dilations', [1] * sp)
    pads = attrs.get('pads', [0] * 2 * sp)
    group = attrs.get('group', 1)
    kernel = [(k - 1) * d + 1 for k, d in zip(w.shape[2:], dil)]
    cout = w.shape[0]
    cin_g = w.shape[1]
    out = None
    for off, win in _windows(x, kernel, strides, pads, 0):
        if any(o % d for o, d in zip(off, dil)):
            continue
        widx = tuple(int(o) // d for o, d in zip(off, dil))
        parts = []
        for g in range(group):
            xs = win[:, g * cin_g:(g + 1) * cin_g]
            wg = w[g * (cout // group):(g + 1) * (cout // group), :,
                   *widx]
            parts.append(np.einsum('nc...,oc->no...', xs, wg))
        term = np.concatenate(parts, axis=1)
        out = term if out is None else out + term
    if b is not None:
        out = out + b.reshape((1, -1) + (1,) * sp)
    return out.astype(x.dtype)


def _pool(x, attrs, kind):
    sp = x.ndim - 2
    kernel = attrs['kernel_shape']
    strides = attrs.get('strides', [1] * sp)
    pads = attrs.get('pads', [0] * 2 * sp)
    ceil_mode = attrs.get('ceil_mode', 0)
    if kind == 'max':
        out = None
        for _, win in _windows(x, kernel, strides, pads, -np.inf, ceil_mode):
            out = win.copy() if out is None else np.maximum(out, win)
        return out.astype(x.dtype)
    total = count = None
    ones = np.ones((1, 1) + x.shape[2:], x.dtype)
    for (_, win), (_, cw) in zip(
            _windows(x, kernel, strides, pads, 0, ceil_mode),
            _windows(ones, kernel, strides, pads, 0, ceil_mode)):
        total = win.copy() if total is None else total + win
        count = cw.copy() if count is None else count + cw
    if attrs.get('count_include_pad', 0):
        count = np.prod(kernel)
    return (total / count).astype(x.dtype)


def run_onnx(blob, feeds):
    nodes, inits, g_in, g_out = parse_model(blob)
    env = dict(inits)
    env.update(feeds)

    def ev(op, ins, outs, attrs):
        a = [env[n] if n else None for n in ins]
        if op == 'MatMul':
            r = a[0] @ a[1]
        elif op == 'Add':
            r = a[0] + a[1]
        elif op == 'Sub':
            r = a[0] - a[1]
        elif op == 'Mul':
            r = a[0] * a[1]
        elif op == 'Div':
            if np.issubdtype(a[0].dtype, np.integer):
                r = np.trunc(a[0] / a[1]).astype(a[0].dtype)
            else:
                r = a[0] / a[1]
        elif op == 'Max':
            r = np.maximum(a[0], a[1])
        elif op == 'Min':
            r = np.minimum(a[0], a[1])
        elif op == 'Pow':
            r = (a[0] ** a[1]).astype(a[0].dtype)
        elif op == 'Mod':
            r = np.fmod(a[0], a[1])
        elif op == 'Neg':
            r = -a[0]
        elif op == 'Exp':
            r = np.exp(a[0])
        elif op == 'Log':
            r = np.log(a[0])
        elif op == 'Tanh':
            r = np.tanh(a[0])
        elif op == 'Sigmoid':
            r = 1.0 / (1.0 + np.exp(-a[0]))
        elif op == 'Erf':
            from scipy.special import erf as _erf
            r = _erf(a[0]).astype(a[0].dtype)
        elif op == 'Sqrt':
            r = np.sqrt(a[0])
        elif op == 'Abs':
            r = np.abs(a[0])
        elif op == 'Sign':
            r = np.sign(a[0])
        elif op == 'Floor':
            r = np.floor(a[0])
        elif op == 'Ceil':
            r = np.ceil(a[0])
        elif op == 'Not':
            r = np.logical_not(a[0])
        elif op == 'And':
            r = np.logical_and(a[0], a[1])
        elif op == 'Or':
            r = np.logical_or(a[0], a[1])
        elif op == 'IsInf':
            r = np.isinf(a[0])
        elif op == 'IsNaN':
            r = np.isnan(a[0])
        elif op == 'Identity':
            r = a[0]
        elif op == 'Reshape':
            r = a[0].reshape([int(d) for d in a[1]])
        elif op == 'Transpose':
            r = np.transpose(a[0], attrs['perm'])
        elif op == 'Expand':
            r = np.broadcast_to(a[0], np.broadcast_shapes(
                a[0].shape, tuple(int(d) for d in a[1]))).copy()
        elif op == 'Unsqueeze':
            r = a[0]
            for ax in sorted(int(x) for x in a[1]):
                r = np.expand_dims(r, ax)
        elif op == 'Squeeze':
            r = np.squeeze(a[0], tuple(int(x) for x in a[1]))
        elif op == 'Concat':
            r = np.concatenate(a, axis=attrs['axis'])
        elif op == 'Slice':
            starts, ends, axes, steps = (a[1], a[2], a[3], a[4])
            sl = [slice(None)] * a[0].ndim
            for s, e2, ax, st in zip(starts, ends, axes, steps):
                e2 = int(e2)
                if e2 < -(2 ** 30):
                    e2 = None
                sl[int(ax)] = slice(int(s), e2, int(st))
            r = a[0][tuple(sl)]
        elif op == 'Pad':
            pads = [int(p) for p in a[1]]
            k = a[0].ndim
            r = np.pad(a[0], list(zip(pads[:k], pads[k:])),
                       constant_values=a[2] if len(a) > 2 else 0)
        elif op == 'Cast':
            r = a[0].astype(NP_OF_ONNX[attrs['to']])
        elif op == 'Where':
            r = np.where(a[0], a[1], a[2])
        elif op == 'Equal':
            r = a[0] == a[1]
        elif op == 'Less':
            r = a[0] < a[1]
        elif op == 'Greater':
            r = a[0] > a[1]
        elif op == 'GreaterOrEqual':
            r = a[0] >= a[1]
        elif op == 'LessOrEqual':
            r = a[0] <= a[1]
        elif op in ('ReduceSum', 'ReduceMax', 'ReduceMin', 'ReduceProd'):
            axes = a[1] if len(a) > 1 else attrs['axes']
            fn = {'ReduceSum': np.sum, 'ReduceMax': np.max,
                  'ReduceMin': np.min, 'ReduceProd': np.prod}[op]
            r = fn(a[0], axis=tuple(int(x) for x in axes),
                   keepdims=bool(attrs.get('keepdims', 1))).astype(
                a[0].dtype)
        elif op == 'ArgMax':
            r = np.argmax(a[0], axis=attrs.get('axis', 0))
            if attrs.get('keepdims', 1):
                r = np.expand_dims(r, attrs.get('axis', 0))
            r = r.astype(np.int64)
        elif op == 'Gather':
            r = np.take(a[0], a[1].astype(np.int64),
                        axis=attrs.get('axis', 0))
        elif op == 'Conv':
            r = _conv(a[0], a[1], a[2] if len(a) > 2 else None, attrs)
        elif op == 'MaxPool':
            r = _pool(a[0], attrs, 'max')
        elif op == 'AveragePool':
            r = _pool(a[0], attrs, 'avg')
        else:
            raise NotImplementedError('evaluator op %s' % op)
        env[outs[0]] = r

    for op, ins, outs, attrs in nodes:
        ev(op, ins, outs, attrs)
    return [env[n] for n in g_out]
