"""Load and serve reference-produced inference artifacts (counterpart of
paddle_tpu/inference/fluid_program.py).

A reference-format inference model directory holds
  __model__ (or *.pdmodel)      serialized framework.proto ProgramDesc
  per-param files / __params__  LoDTensors via SerializeToStream
(reference: inference/api/analysis_predictor.cc:201 PrepareProgram,
inference/io.cc LoadModel, framework/framework.proto:202,
framework/lod_tensor.cc:244 SerializeToStream,
framework/tensor_util.cc:771 TensorToStream).

Block 0's op list runs through a table of torch functions (the eval-mode
semantics of each op) and the whole block is compiled once per feed
signature (jit.StaticFunction: torch.compile with fullgraph), in the place
of the JAX package's jax.jit.

The protobuf wire parsing is hand-rolled (proto2 subset: varint / 64-bit /
length-delimited / 32-bit fields): no protobuf runtime dependency. bf16
LoDTensors are read as their uint16 bits and viewed as torch.bfloat16, so
no ml_dtypes is needed. The detection ops (yolo_box, roi_align, box_coder,
prior_box, anchor_generator, multiclass_nms / 2 / 3) call the port's
vision/ package, with fixed-size padded outputs, so the whole block stays
one compiled program.
"""
import functools
import math
import os
import struct

import numpy as np
import torch
import torch.nn.functional as F

from ..framework import device as device_mod

__all__ = ['parse_program_desc', 'load_fluid_model', 'FluidProgram',
           'read_lod_tensor', 'FLUID_OP_TABLE']


# -- protobuf wire-format reader ---------------------------------------------

def _read_varint(buf, pos):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError('malformed varint')


def _parse_fields(buf):
    """Yield (field_number, wire_type, value) over a message's bytes."""
    pos, end = 0, len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:        # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:      # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:      # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:      # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError('unsupported wire type %d' % wire)
        yield field, wire, val


def _zigzag_i64(v):
    """proto2 int64 fields arrive as two's-complement varints."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _to_i32(v):
    """proto2 int32: negatives arrive sign-extended as 64-bit varints
    (e.g. -1 is 2^64-1), so the 64-bit correction must apply FIRST."""
    if v >= (1 << 63):
        v -= (1 << 64)
    elif v >= (1 << 31):
        v -= (1 << 32)
    return v


def _f32(raw):
    return struct.unpack('<f', raw)[0]


def _f64(raw):
    return struct.unpack('<d', raw)[0]


# -- framework.proto message readers (subset the loader needs) ---------------

class Attr:
    __slots__ = ('name', 'type', 'value')

    def __init__(self, name, type_, value):
        self.name, self.type, self.value = name, type_, value


def _parse_attr(buf):
    """OpDesc.Attr (framework.proto:45)."""
    name = atype = None
    scalar = None
    ints, floats, strings, bools, longs, f64s = [], [], [], [], [], []
    for field, wire, val in _parse_fields(buf):
        if field == 1:
            name = val.decode()
        elif field == 2:
            atype = val
        elif field == 3:
            scalar = _to_i32(val)
        elif field == 4:
            scalar = _f32(val)
        elif field == 5:
            scalar = val.decode()
        elif field == 6:
            if wire == 2:  # packed
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    ints.append(_to_i32(v))
            else:
                ints.append(_to_i32(val))
        elif field == 7:
            if wire == 2 and len(val) != 4:
                floats.extend(struct.unpack('<%df' % (len(val) // 4), val))
            else:
                floats.append(_f32(val))
        elif field == 8:
            strings.append(val.decode())
        elif field == 10:
            scalar = bool(val)
        elif field == 11:
            if wire == 2:
                bools.extend(bool(b) for b in val)
            else:
                bools.append(bool(val))
        elif field == 12:
            scalar = val  # block_idx
        elif field == 13:
            scalar = _zigzag_i64(val)
        elif field == 15:
            if wire == 2:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    longs.append(_zigzag_i64(v))
            else:
                longs.append(_zigzag_i64(val))
        elif field == 16:
            if wire == 2 and len(val) != 8:
                f64s.extend(struct.unpack('<%dd' % (len(val) // 8), val))
            else:
                f64s.append(_f64(val))
    # AttrType enum: INT FLOAT STRING INTS FLOATS STRINGS BOOLEAN BOOLEANS
    #                BLOCK LONG BLOCKS LONGS FLOAT64S
    if atype == 3:
        value = ints
    elif atype == 4:
        value = floats
    elif atype == 5:
        value = strings
    elif atype == 7:
        value = bools
    elif atype == 11:
        value = longs
    elif atype == 12:
        value = f64s
    else:
        value = scalar
    return Attr(name, atype, value)


class OpDesc:
    __slots__ = ('type', 'inputs', 'outputs', 'attrs')

    def __init__(self):
        self.type = None
        self.inputs = {}    # parameter -> [var names]
        self.outputs = {}
        self.attrs = {}     # name -> python value

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])


def _parse_op_var(buf):
    param, args = None, []
    for field, _, val in _parse_fields(buf):
        if field == 1:
            param = val.decode()
        elif field == 2:
            args.append(val.decode())
    return param, args


def _parse_op(buf):
    op = OpDesc()
    for field, _, val in _parse_fields(buf):
        if field == 3:
            op.type = val.decode()
        elif field == 1:
            k, v = _parse_op_var(val)
            op.inputs[k] = v
        elif field == 2:
            k, v = _parse_op_var(val)
            op.outputs[k] = v
        elif field == 4:
            a = _parse_attr(val)
            op.attrs[a.name] = a.value
    return op


# VarType.Type enum values (framework.proto:107)
_DTYPES = {0: torch.bool, 1: torch.int16, 2: torch.int32, 3: torch.int64,
           4: torch.float16, 5: torch.float32, 6: torch.float64,
           20: torch.uint8, 21: torch.int8, 22: torch.bfloat16}
_NP_DTYPES = {torch.bool: np.bool_, torch.int16: np.int16,
              torch.int32: np.int32, torch.int64: np.int64,
              torch.float16: np.float16, torch.float32: np.float32,
              torch.float64: np.float64, torch.uint8: np.uint8,
              torch.int8: np.int8, torch.bfloat16: np.uint16}


def _torch_dtype(code):
    if code not in _DTYPES:
        raise ValueError('unsupported VarType.Type %d' % code)
    return _DTYPES[code]


def _parse_tensor_desc(buf):
    dtype, dims = None, []
    for field, wire, val in _parse_fields(buf):
        if field == 1:
            dtype = val
        elif field == 2:
            if wire == 2:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    dims.append(_zigzag_i64(v))
            else:
                dims.append(_zigzag_i64(val))
    return dtype, dims


class VarDesc:
    __slots__ = ('name', 'persistable', 'dtype', 'shape', 'type_code')

    def __init__(self):
        self.name = None
        self.persistable = False
        self.dtype = None
        self.shape = None
        self.type_code = None


def _parse_var(buf):
    var = VarDesc()
    for field, _, val in _parse_fields(buf):
        if field == 1:
            var.name = val.decode()
        elif field == 3:
            var.persistable = bool(val)
        elif field == 2:
            # VarType: type enum (f1), lod_tensor (f3) -> LoDTensorDesc
            for f2, _, v2 in _parse_fields(val):
                if f2 == 1:
                    var.type_code = v2
                elif f2 == 3:
                    for f3, _, v3 in _parse_fields(v2):
                        if f3 == 1:
                            dt, dims = _parse_tensor_desc(v3)
                            var.dtype, var.shape = dt, dims
    return var


class BlockDesc:
    __slots__ = ('idx', 'parent_idx', 'vars', 'ops')

    def __init__(self):
        self.idx = 0
        self.parent_idx = -1
        self.vars = {}
        self.ops = []


def _parse_block(buf):
    blk = BlockDesc()
    for field, _, val in _parse_fields(buf):
        if field == 1:
            blk.idx = val
        elif field == 2:
            blk.parent_idx = val
        elif field == 3:
            v = _parse_var(val)
            blk.vars[v.name] = v
        elif field == 4:
            blk.ops.append(_parse_op(val))
    return blk


def parse_program_desc(data):
    """bytes of a serialized ProgramDesc -> list of BlockDesc."""
    blocks = []
    for field, _, val in _parse_fields(data):
        if field == 1:
            blocks.append(_parse_block(val))
    if not blocks:
        raise ValueError('no blocks: not a ProgramDesc (or empty model)')
    return blocks


# -- LoDTensor stream reader (lod_tensor.cc SerializeToStream) ---------------

def read_lod_tensor(f):
    """Read ONE serialized LoDTensor from a binary stream -> a CPU tensor
    (bf16 from its uint16 bits)."""
    version = struct.unpack('<I', f.read(4))[0]
    if version != 0:
        raise ValueError('unsupported LoDTensor version %d' % version)
    lod_levels = struct.unpack('<Q', f.read(8))[0]
    for _ in range(lod_levels):
        nbytes = struct.unpack('<Q', f.read(8))[0]
        f.read(nbytes)  # LoD offsets (sequence metadata) are dropped
    tensor_version = struct.unpack('<I', f.read(4))[0]
    if tensor_version != 0:
        raise ValueError('unsupported Tensor version %d' % tensor_version)
    desc_size = struct.unpack('<i', f.read(4))[0]
    dtype_code, dims = _parse_tensor_desc(f.read(desc_size))
    dtype = _torch_dtype(dtype_code)
    np_dtype = np.dtype(_NP_DTYPES[dtype])
    count = math.prod(dims) if dims else 1
    raw = f.read(count * np_dtype.itemsize)
    arr = np.frombuffer(raw, dtype=np_dtype).reshape(dims).copy()
    if dtype == torch.bfloat16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


# -- program container --------------------------------------------------------

def _to_numpy(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


# the scope key of the device the program runs on (never a var name)
_DEVICE = ('device',)


class FluidProgram:
    """Parsed ProgramDesc + loaded persistable vars on `device`, compiled
    once per feed signature."""

    def __init__(self, blocks, params, device=None):
        self.blocks = blocks
        self.device = device_mod.resolve(device)
        self.params = {n: t.to(self.device) for n, t in params.items()}
        blk = blocks[0]
        self.feed_names = []
        self.fetch_names = []
        for op in blk.ops:
            if op.type == 'feed':
                self.feed_names.append((op.attr('col', 0),
                                        op.output('Out')[0]))
            elif op.type == 'fetch':
                self.fetch_names.append((op.attr('col', 0),
                                         op.input('X')[0]))
        self.feed_names = [n for _, n in sorted(self.feed_names)]
        self.fetch_names = [n for _, n in sorted(self.fetch_names)]
        self._program = None

    def input_shapes(self):
        blk = self.blocks[0]
        out = {}
        for n in self.feed_names:
            v = blk.vars.get(n)
            out[n] = tuple(v.shape) if v is not None and v.shape else None
        return out

    def _run_block(self, params, feeds):
        """Block 0's op list through the torch op table."""
        scope = dict(params)
        scope.update(feeds)
        scope[_DEVICE] = self.device
        for op in self.blocks[0].ops:
            if op.type in ('feed', 'fetch'):
                continue
            fn = FLUID_OP_TABLE.get(op.type)
            if fn is None:
                raise NotImplementedError(
                    'fluid op %r has no torch lowering yet (supported: %s)'
                    % (op.type, ', '.join(sorted(FLUID_OP_TABLE))))
            fn(op, scope)
        return [scope[n] for n in self.fetch_names]

    def _forward(self, *feeds):
        return tuple(self._run_block(self.params,
                                     dict(zip(self.feed_names, feeds))))

    def compiled(self):
        """The block as one program per feed signature."""
        if self._program is None:
            from ..jit import StaticFunction
            self._program = StaticFunction(self._forward)
        return self._program

    def program_count(self):
        return 0 if self._program is None else self._program.program_count()

    def compile_count(self):
        return 0 if self._program is None else self._program.compile_count()

    def run(self, feed_dict, return_numpy=True):
        """feed_dict: {feed_var_name: array} -> list of np.ndarray (tensors
        on the device with return_numpy=False).

        The whole block compiles to one program on the first call of a
        feed signature (per AnalysisPredictor's prepared-program
        contract); later runs reuse it."""
        missing = [n for n in self.feed_names if n not in feed_dict]
        if missing:
            raise ValueError('missing feeds: %s' % missing)
        feeds = [v.to(self.device) if isinstance(v, torch.Tensor)
                 else torch.as_tensor(np.asarray(v), device=self.device)
                 for v in (feed_dict[n] for n in self.feed_names)]
        with torch.no_grad():
            outs = self.compiled()(*feeds)
        return [_to_numpy(o) for o in outs] if return_numpy else list(outs)


def load_fluid_model(model_path, params_path=None, device=None):
    """Load a reference-format inference model onto `device` (the current
    device when None).

    model_path: a directory holding `__model__` (+ per-param files or a
    combined params file), or the path of the serialized ProgramDesc
    itself (`.pdmodel` / `__model__`); params_path then points at the
    combined params file (`.pdiparams` / `__params__`).

    Combined-file order: the reference's save/load programs list the
    persistable vars sorted by name (static.io serialize_persistables),
    which is the order the tensors are concatenated in.
    """
    if os.path.isdir(model_path):
        prog_file = os.path.join(model_path, '__model__')
        if not os.path.exists(prog_file):
            cands = [f for f in os.listdir(model_path)
                     if f.endswith('.pdmodel')]
            if not cands:
                raise FileNotFoundError(
                    'no __model__ or *.pdmodel under %s' % model_path)
            prog_file = os.path.join(model_path, cands[0])
            stem = prog_file[:-len('.pdmodel')]
            if params_path is None and os.path.exists(stem + '.pdiparams'):
                params_path = stem + '.pdiparams'
        base_dir = model_path
    else:
        prog_file = model_path
        base_dir = os.path.dirname(model_path)
        if params_path is None:
            stem, ext = os.path.splitext(model_path)
            if ext == '.pdmodel' and os.path.exists(stem + '.pdiparams'):
                params_path = stem + '.pdiparams'

    with open(prog_file, 'rb') as f:
        blocks = parse_program_desc(f.read())

    persistable = sorted(
        n for blk in blocks for n, v in blk.vars.items()
        if v.persistable and n not in ('feed', 'fetch'))
    params = {}
    if params_path is not None:
        with open(params_path, 'rb') as f:
            for name in persistable:
                params[name] = read_lod_tensor(f)
            trailing = f.read(1)
        if trailing:
            raise ValueError('combined params file has trailing bytes — '
                             'var-name ordering mismatch?')
    else:
        for name in persistable:
            p = os.path.join(base_dir, name)
            if not os.path.exists(p):
                raise FileNotFoundError(
                    'parameter file %s missing (separate-files layout)' % p)
            with open(p, 'rb') as f:
                params[name] = read_lod_tensor(f)
    return FluidProgram(blocks, params, device)


# -- the op table: fluid op -> torch ------------------------------------------
#
# Eval-mode inference semantics of the reference CPU kernels
# (paddle/fluid/operators/*), as the JAX package's table computes them. Each
# entry mutates `scope` in place. Shapes are Python ints (math.prod), so a
# compiled block reads no tensor on the host.

FLUID_OP_TABLE = {}


def _op(name):
    def deco(fn):
        FLUID_OP_TABLE[name] = fn
        return fn
    return deco


def _ew_broadcast(x, y, axis):
    """elementwise_* axis semantics: align y's dims starting at `axis`."""
    if axis is None or axis == -1 or x.dim() == y.dim():
        return y
    tail = x.dim() - axis - y.dim()
    return y.reshape(tuple(y.shape) + (1,) * tail)


def _ew(name, fn):
    def impl(op, scope, fn=fn):
        x = scope[op.input('X')[0]]
        y = scope[op.input('Y')[0]]
        y = _ew_broadcast(x, y, op.attr('axis', -1))
        scope[op.output('Out')[0]] = fn(x, y)
    FLUID_OP_TABLE[name] = impl


def _act(name, fn):
    def impl(op, scope, fn=fn):
        scope[op.output('Out')[0]] = fn(scope[op.input('X')[0]])
    FLUID_OP_TABLE[name] = impl


def _no_dynamic(op, *slots):
    """Raise when a tensor-input override slot is wired (the export relied
    on runtime shapes / values this static lowering drops — falling back to
    the attrs would compute wrong results)."""
    for s in slots:
        if op.input(s):
            raise NotImplementedError(
                '%s: dynamic %r tensor input is not supported — '
                're-export with static attrs' % (op.type, s))


def _nearest_fluid(x, out_h, out_w, align_corners):
    """Fluid nearest sampling: floor(dst*scale) when align_corners=False
    (asymmetric), round(dst*(h-1)/(out-1)) when True."""
    h, w = x.shape[2], x.shape[3]
    ar_h = torch.arange(out_h, device=x.device, dtype=torch.float64)
    ar_w = torch.arange(out_w, device=x.device, dtype=torch.float64)
    if align_corners and out_h > 1 and out_w > 1:
        ys = torch.round(ar_h * ((h - 1) / (out_h - 1)))
        xs = torch.round(ar_w * ((w - 1) / (out_w - 1)))
    else:
        ys = torch.floor(ar_h * (h / out_h))
        xs = torch.floor(ar_w * (w / out_w))
    ys = ys.long().clamp(0, h - 1)
    xs = xs.long().clamp(0, w - 1)
    return x[:, :, ys][:, :, :, xs]


def _bilinear_asym(x, out_h, out_w):
    """align_corners=False, align_mode=1 (asymmetric): src = dst*scale, the
    fluid-era default."""
    h, w = x.shape[2], x.shape[3]
    fy = torch.arange(out_h, device=x.device, dtype=torch.float32) * \
        (h / out_h)
    fx = torch.arange(out_w, device=x.device, dtype=torch.float32) * \
        (w / out_w)
    y0 = torch.floor(fy).long().clamp(0, h - 1)
    x0 = torch.floor(fx).long().clamp(0, w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    wy = (fy - y0).to(x.dtype)[:, None]
    wx = (fx - x0).to(x.dtype)[None, :]

    def g(yy, xx):
        return x[:, :, yy][:, :, :, xx]
    top = g(y0, x0) * (1 - wx) + g(y0, x1) * wx
    bot = g(y1, x0) * (1 - wx) + g(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def _interp(op, scope, method):
    x = scope[op.input('Input')[0] if op.input('Input')
              else op.input('X')[0]]  # NCHW
    if op.attr('data_layout', 'NCHW') != 'NCHW':
        raise NotImplementedError('interp: NCHW only')
    _no_dynamic(op, 'OutSize', 'SizeTensor', 'Scale')
    out_h = op.attr('out_h', -1)
    out_w = op.attr('out_w', -1)
    scale = op.attr('scale', [])
    if (out_h is None or out_h <= 0) and scale:
        if isinstance(scale, (int, float)):
            scale = [scale, scale]
        out_h = int(x.shape[2] * scale[0])
        out_w = int(x.shape[3] * scale[-1])
    if not out_h or out_h <= 0 or not out_w or out_w <= 0:
        raise NotImplementedError(
            'interp: no usable out_h/out_w attrs or scale')
    align = op.attr('align_corners', False)
    if align and method != 'nearest':
        raise NotImplementedError('interp: align_corners=True not '
                                  'supported — export with '
                                  'align_corners=False')
    if method == 'nearest':
        out = _nearest_fluid(x, out_h, out_w, align)
    elif op.attr('align_mode', 1) == 1:
        out = _bilinear_asym(x, out_h, out_w)
    else:
        # half-pixel centres, antialiased when shrinking (the JAX package's
        # jax.image.resize 'linear')
        out = F.interpolate(x, size=(out_h, out_w), mode='bilinear',
                            align_corners=False,
                            antialias=out_h < x.shape[2] or
                            out_w < x.shape[3])
    scope[op.output('Out')[0]] = out.to(x.dtype)


def _reduce(fn):
    def impl(op, scope):
        x = scope[op.input('X')[0]]
        dims = tuple(op.attr('dim', [0]))
        if op.attr('reduce_all', False) or not dims:
            dims = tuple(range(x.dim()))
        scope[op.output('Out')[0]] = fn(
            x, tuple(d % x.dim() for d in dims) if x.dim() else (),
            op.attr('keep_dim', False))
    return impl


def _prod(x, dims, keep):
    for d in sorted(dims, reverse=True):
        x = torch.prod(x, d, keepdim=keep)
    return x


def _same_pads(size, k, stride, dil):
    """XLA's SAME padding of one spatial dim: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dil + 1 - size, 0)
    return total // 2, total - total // 2


def _init_table():
    _ew('elementwise_add', torch.add)
    _ew('elementwise_sub', torch.sub)
    _ew('elementwise_mul', torch.mul)
    _ew('elementwise_div', torch.div)
    _ew('elementwise_max', torch.maximum)
    _ew('elementwise_min', torch.minimum)
    _ew('elementwise_pow', torch.pow)
    _ew('elementwise_floordiv', torch.floor_divide)
    _ew('elementwise_mod', torch.remainder)

    _act('relu', torch.relu)
    _act('sigmoid', torch.sigmoid)
    _act('tanh', torch.tanh)
    _act('sqrt', torch.sqrt)
    _act('exp', torch.exp)
    _act('square', torch.square)
    _act('abs', torch.abs)
    _act('relu6', lambda x: torch.clamp(x, 0, 6))
    _act('hard_swish', lambda x: x * torch.clamp(x + 3, 0, 6) / 6)
    _act('hard_sigmoid', lambda x: torch.clamp(0.2 * x + 0.5, 0, 1))
    _act('swish', lambda x: x * torch.sigmoid(x))
    _act('mish', lambda x: x * torch.tanh(F.softplus(x)))
    _act('softplus', F.softplus)
    _act('log_softmax', lambda x: torch.log_softmax(x, dim=-1))
    _act('floor', torch.floor)
    _act('ceil', torch.ceil)
    _act('round', torch.round)
    _act('sign', torch.sign)
    _act('reciprocal', lambda x: 1.0 / x)
    _act('logical_not', torch.logical_not)

    @_op('leaky_relu')
    def _leaky_relu(op, scope):
        x = scope[op.input('X')[0]]
        a = op.attr('alpha', 0.02)
        scope[op.output('Out')[0]] = torch.where(x > 0, x, a * x)

    @_op('gelu')
    def _gelu(op, scope):
        x = scope[op.input('X')[0]]
        approx = 'tanh' if op.attr('approximate', False) else 'none'
        scope[op.output('Out')[0]] = F.gelu(x, approximate=approx)

    @_op('elu')
    def _elu(op, scope):
        x = scope[op.input('X')[0]]
        a = op.attr('alpha', 1.0)
        scope[op.output('Out')[0]] = torch.where(
            x > 0, x, a * (torch.exp(x) - 1))

    @_op('prelu')
    def _prelu(op, scope):
        x = scope[op.input('X')[0]]
        alpha = scope[op.input('Alpha')[0]]
        if op.attr('mode', 'all') == 'channel' and x.dim() >= 2:
            alpha = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
        scope[op.output('Out')[0]] = torch.where(x > 0, x, alpha * x)

    @_op('pow')
    def _pow(op, scope):
        x = scope[op.input('X')[0]]
        scope[op.output('Out')[0]] = x ** op.attr('factor', 1.0)

    # -- comparison (Out is bool) -------------------------------------------
    for cmp_name, cmp_fn in (('equal', torch.eq), ('not_equal', torch.ne),
                             ('greater_than', torch.gt),
                             ('greater_equal', torch.ge),
                             ('less_than', torch.lt),
                             ('less_equal', torch.le)):
        def _cmp(op, scope, fn=cmp_fn):
            scope[op.output('Out')[0]] = fn(scope[op.input('X')[0]],
                                            scope[op.input('Y')[0]])
        FLUID_OP_TABLE[cmp_name] = _cmp

    # -- reductions (one decoder for the whole reduce_* family) ------------
    FLUID_OP_TABLE['reduce_max'] = _reduce(
        lambda x, d, k: torch.amax(x, d, keepdim=k))
    FLUID_OP_TABLE['reduce_min'] = _reduce(
        lambda x, d, k: torch.amin(x, d, keepdim=k))
    FLUID_OP_TABLE['reduce_prod'] = _reduce(_prod)
    FLUID_OP_TABLE['reduce_mean'] = _reduce(
        lambda x, d, k: torch.mean(x, d, keepdim=k))
    FLUID_OP_TABLE['reduce_sum'] = _reduce(
        lambda x, d, k: torch.sum(x, d, keepdim=k))

    @_op('stack')
    def _stack(op, scope):
        xs = [scope[n] for n in op.input('X')]
        scope[op.output('Y')[0]] = torch.stack(xs, dim=op.attr('axis', 0))

    @_op('split')
    def _split(op, scope):
        _no_dynamic(op, 'AxisTensor', 'SectionsTensorList')
        x = scope[op.input('X')[0]]
        axis = op.attr('axis', 0)
        sections = list(op.attr('sections', []))
        outs = op.output('Out')
        if sections:
            if sections.count(-1) > 1:
                raise ValueError('split: at most one -1 section')
            if -1 in sections:
                known = sum(s for s in sections if s != -1)
                sections[sections.index(-1)] = x.shape[axis] - known
            parts = torch.split(x, sections, dim=axis)
        else:
            parts = torch.chunk(x, op.attr('num', len(outs)), dim=axis)
        for name, part in zip(outs, parts):
            scope[name] = part

    @_op('shape')
    def _shape(op, scope):
        x = scope[op.input('Input')[0]]
        scope[op.output('Out')[0]] = torch.tensor(
            list(x.shape), dtype=torch.int32, device=x.device)

    @_op('fill_constant')
    def _fill_constant(op, scope):
        _no_dynamic(op, 'ShapeTensor', 'ShapeTensorList', 'ValueTensor')
        shape = [int(s) for s in op.attr('shape', [])]
        scope[op.output('Out')[0]] = torch.full(
            shape, op.attr('value', 0.0),
            dtype=_torch_dtype(op.attr('dtype', 5)), device=scope[_DEVICE])

    @_op('expand_v2')
    def _expand_v2(op, scope):
        _no_dynamic(op, 'Shape', 'expand_shapes_tensor')
        x = scope[op.input('X')[0]]
        shape = [int(s) for s in op.attr('shape', [])]
        # paddle aligns x to the target from the RIGHT when the target
        # rank exceeds x's; -1/0 entries keep x's corresponding dim
        off = len(shape) - x.dim()
        if off < 0:
            raise ValueError('expand_v2: target rank %d < input rank %d'
                             % (len(shape), x.dim()))
        full = []
        for i, s in enumerate(shape):
            if s in (-1, 0):
                if i < off:
                    raise ValueError(
                        'expand_v2: -1/0 in a dim (%d) with no '
                        'corresponding input dim' % i)
                full.append(x.shape[i - off])
            else:
                full.append(s)
        scope[op.output('Out')[0]] = torch.broadcast_to(x, full)

    @_op('tile')
    def _tile(op, scope):
        x = scope[op.input('X')[0]]
        scope[op.output('Out')[0]] = torch.tile(
            x, tuple(op.attr('repeat_times', [1])))

    @_op('clip')
    def _clip(op, scope):
        _no_dynamic(op, 'Min', 'Max')
        x = scope[op.input('X')[0]]
        scope[op.output('Out')[0]] = torch.clamp(
            x, op.attr('min', float('-inf')), op.attr('max', float('inf')))

    @_op('one_hot_v2')
    def _one_hot_v2(op, scope):
        x = scope[op.input('X')[0]]
        depth = op.attr('depth', 1)
        scope[op.output('Out')[0]] = F.one_hot(x.long(), depth).to(
            torch.float32)

    def _normalize(x, red, eps):
        mean = torch.mean(x, dim=red, keepdim=True)
        var = torch.var(x, dim=red, keepdim=True, correction=0)
        return (x - mean) / torch.sqrt(var + eps)

    @_op('layer_norm')
    def _layer_norm(op, scope):
        x = scope[op.input('X')[0]]
        ax = op.attr('begin_norm_axis', 1)
        y = _normalize(x, tuple(range(ax, x.dim())), op.attr('epsilon', 1e-5))
        shape = (1,) * ax + tuple(x.shape[ax:])
        if op.input('Scale'):
            y = y * scope[op.input('Scale')[0]].reshape(shape)
        if op.input('Bias'):
            y = y + scope[op.input('Bias')[0]].reshape(shape)
        scope[op.output('Y')[0]] = y

    @_op('instance_norm')
    def _instance_norm(op, scope):
        x = scope[op.input('X')[0]]  # NCHW
        y = _normalize(x, tuple(range(2, x.dim())), op.attr('epsilon', 1e-5))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if op.input('Scale'):
            y = y * scope[op.input('Scale')[0]].reshape(shape)
        if op.input('Bias'):
            y = y + scope[op.input('Bias')[0]].reshape(shape)
        scope[op.output('Y')[0]] = y

    for iname, imethod in (('nearest_interp', 'nearest'),
                           ('nearest_interp_v2', 'nearest'),
                           ('bilinear_interp', 'linear'),
                           ('bilinear_interp_v2', 'linear')):
        FLUID_OP_TABLE[iname] = functools.partial(_interp, method=imethod)

    @_op('pad3d')
    def _pad3d(op, scope):
        x = scope[op.input('X')[0]]
        pads = op.attr('paddings', [0] * 6)
        if op.attr('mode', 'constant') != 'constant':
            raise NotImplementedError('pad3d: constant mode only')
        # paddle order: [front, back] per spatial dim, last dim first — the
        # order F.pad takes
        spatial = x.dim() - 2
        scope[op.output('Out')[0]] = F.pad(
            x, tuple(pads[:2 * spatial]), value=op.attr('value', 0.0))

    @_op('pad2d')
    def _pad2d(op, scope):
        x = scope[op.input('X')[0]]  # NCHW
        pads = op.attr('paddings', [0, 0, 0, 0])  # t, b, l, r
        if op.attr('mode', 'constant') != 'constant':
            raise NotImplementedError('pad2d: constant mode only')
        scope[op.output('Out')[0]] = F.pad(
            x, (pads[2], pads[3], pads[0], pads[1]),
            value=op.attr('pad_value', 0.0))

    # -- detection (PP-YOLO family serving, BASELINE config 4) --------------
    # the vision implementations (vision/ops.py, vision/detection.py);
    # fixed-size padded outputs keep the whole block one program

    @_op('yolo_box')
    def _yolo_box(op, scope):
        from ..vision.ops import yolo_box
        boxes, scores = yolo_box(
            scope[op.input('X')[0]], scope[op.input('ImgSize')[0]],
            anchors=list(op.attr('anchors', [])),
            class_num=op.attr('class_num', 1),
            conf_thresh=op.attr('conf_thresh', 0.01),
            downsample_ratio=op.attr('downsample_ratio', 32),
            clip_bbox=op.attr('clip_bbox', True),
            scale_x_y=op.attr('scale_x_y', 1.0),
            iou_aware=op.attr('iou_aware', False),
            iou_aware_factor=op.attr('iou_aware_factor', 0.5))
        scope[op.output('Boxes')[0]] = boxes
        scope[op.output('Scores')[0]] = scores

    def _nms_common(op, scope, with_index):
        from ..vision.detection import multiclass_nms
        if op.attr('nms_eta', 1.0) != 1.0:
            raise NotImplementedError(
                'multiclass_nms: adaptive NMS (nms_eta != 1) is not '
                'implemented — suppression would silently use a fixed '
                'threshold')
        res = multiclass_nms(
            scope[op.input('BBoxes')[0]], scope[op.input('Scores')[0]],
            score_threshold=op.attr('score_threshold', 0.05),
            nms_top_k=op.attr('nms_top_k', 1000),
            keep_top_k=op.attr('keep_top_k', 100),
            nms_threshold=op.attr('nms_threshold', 0.3),
            normalized=op.attr('normalized', True),
            background_label=op.attr('background_label', 0),
            return_index=with_index, return_rois_num=True)
        scope[op.output('Out')[0]] = res[0]
        if with_index and op.output('Index'):
            scope[op.output('Index')[0]] = res[1]
        rois = op.output('NmsRoisNum') or op.output('RoisNum')
        if rois:
            scope[rois[0]] = res[-1]

    FLUID_OP_TABLE['multiclass_nms'] = functools.partial(
        _nms_common, with_index=False)
    FLUID_OP_TABLE['multiclass_nms2'] = functools.partial(
        _nms_common, with_index=True)
    FLUID_OP_TABLE['multiclass_nms3'] = functools.partial(
        _nms_common, with_index=True)

    @_op('roi_align')
    def _roi_align(op, scope):
        from ..vision.ops import roi_align
        if not op.input('RoisNum'):
            raise NotImplementedError(
                'roi_align: LoD-carried roi batching is not supported '
                '(SURVEY §7.5) — re-export with the RoisNum input')
        scope[op.output('Out')[0]] = roi_align(
            scope[op.input('X')[0]], scope[op.input('ROIs')[0]],
            scope[op.input('RoisNum')[0]],
            output_size=(op.attr('pooled_height', 1),
                         op.attr('pooled_width', 1)),
            spatial_scale=op.attr('spatial_scale', 1.0),
            sampling_ratio=op.attr('sampling_ratio', -1),
            aligned=op.attr('aligned', True))

    @_op('box_coder')
    def _box_coder(op, scope):
        from ..vision.ops import box_coder
        pbv = (scope[op.input('PriorBoxVar')[0]]
               if op.input('PriorBoxVar')
               else list(op.attr('variance', [])) or [1.0, 1.0, 1.0, 1.0])
        scope[op.output('OutputBox')[0]] = box_coder(
            scope[op.input('PriorBox')[0]], pbv,
            scope[op.input('TargetBox')[0]],
            code_type=op.attr('code_type', 'encode_center_size'),
            box_normalized=op.attr('box_normalized', True),
            axis=op.attr('axis', 0))

    @_op('prior_box')
    def _prior_box(op, scope):
        from ..vision.ops import prior_box
        boxes, variances = prior_box(
            scope[op.input('Input')[0]], scope[op.input('Image')[0]],
            min_sizes=list(op.attr('min_sizes', [])),
            max_sizes=list(op.attr('max_sizes', [])) or None,
            aspect_ratios=list(op.attr('aspect_ratios', [1.0])),
            variance=list(op.attr('variances', [0.1, 0.1, 0.2, 0.2])),
            flip=op.attr('flip', False), clip=op.attr('clip', False),
            steps=(op.attr('step_w', 0.0), op.attr('step_h', 0.0)),
            offset=op.attr('offset', 0.5),
            min_max_aspect_ratios_order=op.attr(
                'min_max_aspect_ratios_order', False))
        scope[op.output('Boxes')[0]] = boxes
        scope[op.output('Variances')[0]] = variances

    @_op('anchor_generator')
    def _anchor_generator(op, scope):
        from ..vision.detection import anchor_generator
        anchors, variances = anchor_generator(
            scope[op.input('Input')[0]],
            anchor_sizes=list(op.attr('anchor_sizes', [])),
            aspect_ratios=list(op.attr('aspect_ratios', [])),
            variances=list(op.attr('variances', [])) or None,
            stride=tuple(op.attr('stride', [])) or None,
            offset=op.attr('offset', 0.5))
        scope[op.output('Anchors')[0]] = anchors
        scope[op.output('Variances')[0]] = variances

    @_op('norm')
    def _norm(op, scope):
        x = scope[op.input('X')[0]]
        ax = op.attr('axis', -1)
        eps = op.attr('epsilon', 1e-10)
        scope[op.output('Out')[0]] = x / torch.sqrt(
            torch.sum(x * x, dim=ax, keepdim=True) + eps)

    @_op('mul')
    def _mul(op, scope):
        x = scope[op.input('X')[0]]
        y = scope[op.input('Y')[0]]
        xd = op.attr('x_num_col_dims', 1)
        yd = op.attr('y_num_col_dims', 1)
        xs, ys = tuple(x.shape), tuple(y.shape)
        x2 = x.reshape(math.prod(xs[:xd]), -1)
        y2 = y.reshape(math.prod(ys[:yd]), -1)
        scope[op.output('Out')[0]] = (x2 @ y2).reshape(xs[:xd] + ys[yd:])

    @_op('matmul')
    def _matmul(op, scope):
        x = scope[op.input('X')[0]]
        y = scope[op.input('Y')[0]]
        if op.attr('transpose_X', False):
            x = x.transpose(-1, -2)
        if op.attr('transpose_Y', False):
            y = y.transpose(-1, -2)
        scope[op.output('Out')[0]] = torch.matmul(x, y) * \
            op.attr('alpha', 1.0)

    @_op('matmul_v2')
    def _matmul_v2(op, scope):
        x = scope[op.input('X')[0]]
        y = scope[op.input('Y')[0]]
        if op.attr('trans_x', False):
            x = x.transpose(-1, -2)
        if op.attr('trans_y', False):
            y = y.transpose(-1, -2)
        scope[op.output('Out')[0]] = torch.matmul(x, y)

    @_op('fc')
    def _fc(op, scope):
        x = scope[op.input('Input')[0]]
        w = scope[op.input('W')[0]]
        ncol = op.attr('in_num_col_dims', 1)
        xs = tuple(x.shape)
        out = x.reshape(math.prod(xs[:ncol]), -1) @ w
        if op.input('Bias'):
            out = out + scope[op.input('Bias')[0]]
        if op.attr('activation_type', '') == 'relu':
            out = torch.relu(out)
        scope[op.output('Out')[0]] = out.reshape(xs[:ncol] + (w.shape[1],))

    @_op('softmax')
    def _softmax(op, scope):
        x = scope[op.input('X')[0]]
        scope[op.output('Out')[0]] = torch.softmax(x, dim=op.attr('axis', -1))

    @_op('scale')
    def _scale(op, scope):
        x = scope[op.input('X')[0]]
        s = op.attr('scale', 1.0)
        b = op.attr('bias', 0.0)
        if op.attr('bias_after_scale', True):
            out = x * s + b
        else:
            out = (x + b) * s
        scope[op.output('Out')[0]] = out

    @_op('mean')
    def _mean(op, scope):
        scope[op.output('Out')[0]] = torch.mean(scope[op.input('X')[0]])

    @_op('reshape2')
    def _reshape2(op, scope):
        x = scope[op.input('X')[0]]
        shape = [int(s) for s in op.attr('shape', [])]
        scope[op.output('Out')[0]] = torch.reshape(x, shape)

    @_op('transpose2')
    def _transpose2(op, scope):
        x = scope[op.input('X')[0]]
        scope[op.output('Out')[0]] = x.permute(
            *op.attr('axis', list(range(x.dim()))[::-1]))

    @_op('flatten2')
    def _flatten2(op, scope):
        x = scope[op.input('X')[0]]
        ax = op.attr('axis', 1)
        scope[op.output('Out')[0]] = x.reshape(
            math.prod(tuple(x.shape)[:ax]), -1)

    @_op('flatten_contiguous_range')
    def _flatten_range(op, scope):
        x = scope[op.input('X')[0]]
        start = op.attr('start_axis', 1)
        stop = op.attr('stop_axis', -1)
        if stop < 0:
            stop += x.dim()
        xs = tuple(x.shape)
        shape = xs[:start] + (math.prod(xs[start:stop + 1]),) + xs[stop + 1:]
        scope[op.output('Out')[0]] = x.reshape(shape)

    @_op('concat')
    def _concat(op, scope):
        xs = [scope[n] for n in op.input('X')]
        scope[op.output('Out')[0]] = torch.cat(xs, dim=op.attr('axis', 0))

    @_op('dropout')
    def _dropout(op, scope):
        x = scope[op.input('X')[0]]
        # inference semantics only (is_test); downgrade_in_infer scales
        impl = op.attr('dropout_implementation', 'downgrade_in_infer')
        p = op.attr('dropout_prob', 0.5)
        if impl == 'downgrade_in_infer':
            x = x * (1.0 - p)
        scope[op.output('Out')[0]] = x

    @_op('conv2d')
    def _conv2d(op, scope):
        x = scope[op.input('Input')[0]]     # NCHW
        w = scope[op.input('Filter')[0]]    # OIHW
        strides = tuple(op.attr('strides', [1, 1]))
        dil = tuple(op.attr('dilations', [1, 1]))
        algo = op.attr('padding_algorithm', 'EXPLICIT')
        if algo == 'SAME':
            (t, b), (le, r) = (
                _same_pads(x.shape[2 + i], w.shape[2 + i], strides[i],
                           dil[i]) for i in range(2))
        elif algo == 'VALID':
            t = b = le = r = 0
        else:
            pads = op.attr('paddings', [0, 0])
            if len(pads) == 2:
                t = b = pads[0]
                le = r = pads[1]
            else:
                t, b, le, r = pads
        scope[op.output('Output')[0]] = F.conv2d(
            F.pad(x, (le, r, t, b)), w, None, strides, 0, dil,
            op.attr('groups', 1))

    @_op('depthwise_conv2d')
    def _depthwise_conv2d(op, scope):
        _conv2d(op, scope)

    @_op('pool2d')
    def _pool2d(op, scope):
        x = scope[op.input('X')[0]]
        ptype = op.attr('pooling_type', 'max')
        ksize = tuple(op.attr('ksize', [2, 2]))
        strides = tuple(op.attr('strides', [2, 2]))
        pads = op.attr('paddings', [0, 0])
        if op.attr('global_pooling', False) or op.attr('adaptive', False):
            # adaptive with output 1x1 == global; other adaptive sizes
            # unsupported (raise rather than silently wrong)
            if op.attr('adaptive', False) and ksize != (1, 1):
                raise NotImplementedError('adaptive pool2d with output '
                                          '!= 1x1')
            fn = torch.amax if ptype == 'max' else torch.mean
            scope[op.output('Out')[0]] = fn(x, dim=(2, 3), keepdim=True)
            return
        pad4 = (pads[1], pads[1], pads[0], pads[0])
        if ptype == 'max':
            out = F.max_pool2d(F.pad(x, pad4, value=float('-inf')), ksize,
                               strides)
        else:
            area = float(ksize[0] * ksize[1])
            s = F.avg_pool2d(F.pad(x, pad4), ksize, strides) * area
            if op.attr('exclusive', True) and any(p for p in pads):
                cnt = F.avg_pool2d(F.pad(torch.ones_like(x), pad4), ksize,
                                   strides) * area
                out = s / cnt
            else:
                out = s / area
        scope[op.output('Out')[0]] = out

    @_op('batch_norm')
    def _batch_norm(op, scope):
        x = scope[op.input('X')[0]]
        mean = scope[op.input('Mean')[0]]
        var = scope[op.input('Variance')[0]]
        scale = scope[op.input('Scale')[0]]
        bias = scope[op.input('Bias')[0]]
        eps = op.attr('epsilon', 1e-5)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        out = (x - mean.reshape(shape)) / torch.sqrt(
            var.reshape(shape) + eps)
        scope[op.output('Y')[0]] = out * scale.reshape(shape) + \
            bias.reshape(shape)

    @_op('lookup_table_v2')
    def _lookup_v2(op, scope):
        w = scope[op.input('W')[0]]
        ids = scope[op.input('Ids')[0]]
        scope[op.output('Out')[0]] = w[ids.long()]

    @_op('lookup_table')
    def _lookup(op, scope):
        w = scope[op.input('W')[0]]
        ids = scope[op.input('Ids')[0]]
        scope[op.output('Out')[0]] = w[ids.squeeze(-1).long()]

    @_op('arg_max')
    def _arg_max(op, scope):
        x = scope[op.input('X')[0]]
        scope[op.output('Out')[0]] = torch.argmax(
            x, dim=op.attr('axis', -1)).to(torch.int64)

    @_op('squeeze2')
    def _squeeze2(op, scope):
        x = scope[op.input('X')[0]]
        axes = tuple(op.attr('axes', []))
        scope[op.output('Out')[0]] = (
            torch.squeeze(x, axes) if axes else torch.squeeze(x))

    @_op('unsqueeze2')
    def _unsqueeze2(op, scope):
        out = scope[op.input('X')[0]]
        for ax in sorted(op.attr('axes', [])):
            out = torch.unsqueeze(out, ax)
        scope[op.output('Out')[0]] = out

    @_op('assign')
    def _assign(op, scope):
        scope[op.output('Out')[0]] = scope[op.input('X')[0]]

    @_op('cast')
    def _cast(op, scope):
        x = scope[op.input('X')[0]]
        scope[op.output('Out')[0]] = x.to(
            _torch_dtype(op.attr('out_dtype', 5)))

    @_op('slice')
    def _slice(op, scope):
        x = scope[op.input('Input')[0]]
        axes = op.attr('axes', [])
        starts = op.attr('starts', [])
        ends = op.attr('ends', [])
        idx = [slice(None)] * x.dim()
        for ax, st, en in zip(axes, starts, ends):
            idx[ax] = slice(st, en)
        out = x[tuple(idx)]
        dec = op.attr('decrease_axis', [])
        if dec:
            # dygraph-exported x[0]-style slices squeeze the unit dims
            out = torch.squeeze(out, tuple(dec))
        scope[op.output('Out')[0]] = out


_init_table()
