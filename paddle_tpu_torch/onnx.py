"""paddle.onnx.export (counterpart of paddle_tpu/onnx.py; reference:
python/paddle/onnx/export.py, a thin paddle2onnx wrapper).

The eval forward is traced with torch.export, as jit.save traces it, on
the model's device, and decomposed to core ATen (`run_decompositions()`).
Each ATen op then goes through a handler of its own into ONNX nodes, and
the ONNX protobuf is written by hand with the JAX package's writer (no
onnx or paddle2onnx package is needed). Parameters, buffers and lifted
constants become initializers, copied to the host; a node whose inputs
are all known is evaluated at export time and becomes a constant, so
iota, masks and position ids are constants, as the JAX exporter folds
them. Softmax, layer norm, batch norm and GELU are written as the
elementwise ops and reductions their jaxprs hold in the JAX exporter's
graphs.

The flash custom op (`paddle_tpu_torch::flash_fwd`, which attention at 512
tokens or more takes on every device) is lowered to the ONNX ops of its
plain version, ops/flash_attention.py's flash_attention_fwd_ref: a scaled
MatMul, the top-left causal mask as a constant, the softmax in f32 and a
MatMul. The JAX exporter writes the same for a model whose attention takes
the plain route (the CPU at 512 <= n < 1024); it raises on `pallas_call`
on the TPU and on the blockwise `scan` at n >= 1024.

Ops outside the handled set, dtypes ONNX export does not carry (bfloat16
among them) and shapes that are not fully static raise, as in the JAX
package: never a silent manifest.
"""
import operator
import struct

import numpy as np
import torch

__all__ = ['export']


# -- minimal protobuf writer (ONNX wire format) ------------------------------

def _varint(n):
    out = b''
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            out += bytes([b])
            return out


def _key(field, wire):
    return _varint((field << 3) | wire)


def _f_int(field, value):
    return _key(field, 0) + _varint(int(value))


def _f_bytes(field, data):
    if isinstance(data, str):
        data = data.encode()
    return _key(field, 2) + _varint(len(data)) + bytes(data)


def _f_float(field, value):
    return _key(field, 5) + struct.pack('<f', float(value))


def _f_packed_ints(field, values):
    body = b''.join(_varint(v) for v in values)
    return _key(field, 2) + _varint(len(body)) + body


# ONNX TensorProto.DataType
_DTYPES = {
    np.dtype(np.float32): 1, np.dtype(np.uint8): 2, np.dtype(np.int8): 3,
    np.dtype(np.int16): 5, np.dtype(np.int32): 6, np.dtype(np.int64): 7,
    np.dtype(np.bool_): 9, np.dtype(np.float16): 10,
    np.dtype(np.float64): 11, np.dtype(np.uint32): 12,
    np.dtype(np.uint64): 13,
}


def _onnx_dtype(dt):
    dt = np.dtype(dt)
    if dt not in _DTYPES:
        raise NotImplementedError('ONNX export: unsupported dtype %s' % dt)
    return _DTYPES[dt]


def _tensor_proto(name, arr):
    arr = np.ascontiguousarray(arr)
    body = b''.join(_f_int(1, d) for d in arr.shape)
    body += _f_int(2, _onnx_dtype(arr.dtype))
    body += _f_bytes(8, name)
    body += _f_bytes(9, arr.tobytes())
    return body


def _value_info(name, shape, dtype):
    shape_body = b''.join(
        _f_bytes(1, _f_int(1, d)) for d in shape)   # dim { dim_value: d }
    tensor_type = _f_int(1, _onnx_dtype(dtype)) + _f_bytes(2, shape_body)
    type_proto = _f_bytes(1, tensor_type)
    return _f_bytes(1, name) + _f_bytes(2, type_proto)


def _attr(name, value):
    body = _f_bytes(1, name)
    if isinstance(value, bool):
        body += _f_int(3, int(value)) + _f_int(20, 2)
    elif isinstance(value, int):
        body += _f_int(3, value) + _f_int(20, 2)           # INT
    elif isinstance(value, float):
        body += _f_float(2, value) + _f_int(20, 1)          # FLOAT
    elif isinstance(value, str):
        body += _f_bytes(4, value) + _f_int(20, 3)          # STRING
    elif isinstance(value, (list, tuple)) and all(
            isinstance(v, int) for v in value):
        body += _f_packed_ints(8, value) + _f_int(20, 7)    # INTS
    else:
        raise NotImplementedError('attr %r=%r' % (name, value))
    return body


def _node(op_type, inputs, outputs, attrs=None, name=''):
    body = b''.join(_f_bytes(1, i) for i in inputs)
    body += b''.join(_f_bytes(2, o) for o in outputs)
    if name:
        body += _f_bytes(3, name)
    body += _f_bytes(4, op_type)
    for k, v in (attrs or {}).items():
        body += _f_bytes(5, _attr(k, v))
    return body


def _model_proto(graph_body, opset_version):
    body = _f_int(1, 8)                        # ir_version
    body += _f_bytes(2, 'paddle_tpu')          # producer_name
    body += _f_bytes(7, graph_body)            # graph
    opset = _f_bytes(1, '') + _f_int(2, opset_version)
    body += _f_bytes(8, opset)                 # opset_import
    return body


# -- torch.export graph -> ONNX graph ------------------------------------------

_NP_OF_TORCH = {
    torch.float32: np.float32, torch.uint8: np.uint8, torch.int8: np.int8,
    torch.int16: np.int16, torch.int32: np.int32, torch.int64: np.int64,
    torch.bool: np.bool_, torch.float16: np.float16,
    torch.float64: np.float64, torch.uint32: np.uint32,
    torch.uint64: np.uint64,
}


def _np_dtype(dt):
    """numpy's dtype for a torch dtype ONNX export carries; any other
    raises as _onnx_dtype does."""
    if dt not in _NP_OF_TORCH:
        raise NotImplementedError('ONNX export: unsupported dtype %s'
                                  % str(dt).replace('torch.', ''))
    return np.dtype(_NP_OF_TORCH[dt])


def _dt(dt):
    """The ONNX TensorProto type of a torch dtype."""
    return _onnx_dtype(_np_dtype(dt))


def _vals(val):
    return [v for v in (val if isinstance(val, (tuple, list)) else [val])
            if isinstance(v, torch.Tensor)]


# an op that only checks its input's metadata: nothing to convert
_NO_OUTPUT = ('_assert_tensor_metadata',)
_IDENTITY = ('clone', 'alias')
_UNARY = {'neg': 'Neg', 'exp': 'Exp', 'log': 'Log', 'tanh': 'Tanh',
          'sigmoid': 'Sigmoid', 'erf': 'Erf', 'sqrt': 'Sqrt', 'abs': 'Abs',
          'sign': 'Sign', 'floor': 'Floor', 'ceil': 'Ceil'}
_BINARY = {'add': 'Add', 'sub': 'Sub', 'mul': 'Mul', 'maximum': 'Max',
           'minimum': 'Min'}
_COMPARE = {'eq': 'Equal', 'lt': 'Less', 'le': 'LessOrEqual',
            'gt': 'Greater', 'ge': 'GreaterOrEqual'}
_LOGICAL = {'logical_and': 'And', 'bitwise_and': 'And',
            'bitwise_or': 'Or'}
_FLASH_FWD = 'paddle_tpu_torch.flash_fwd'


def _op_name(target):
    """'aten.mm' for aten.mm.default, 'paddle_tpu_torch.flash_fwd' for the
    custom op: the op without its overload."""
    name = str(target)
    return name.rsplit('.', 1)[0] if isinstance(
        target, torch._ops.OpOverload) else name


class _Converter:
    def __init__(self, opset):
        self.opset = opset
        self.nodes = []            # (op_type, inputs, outputs, attrs, name)
        self.const_vals = {}       # onnx name -> known torch value
        self.names = {}            # fx node -> onnx name (list: several)
        self.counter = 0
        self.flash_lowered = 0

    def fresh(self, hint='t'):
        self.counter += 1
        return '%s_%d' % (hint, self.counter)

    def add_const(self, name, value):
        self.const_vals[name] = value
        return name

    def const(self, value, dtype, hint='const'):
        """A new initializer holding `value` as `dtype` (a torch dtype)."""
        return self.add_const(self.fresh(hint),
                              torch.tensor(value, dtype=dtype))

    def ints(self, values, hint):
        return self.const(list(values), torch.int64, hint)

    def emit(self, op_type, inputs, outputs, attrs=None):
        self.nodes.append((op_type, list(inputs), list(outputs), attrs,
                           self.fresh(op_type)))
        return outputs[0] if len(outputs) == 1 else outputs

    def op(self, op_type, inputs, attrs=None, hint=None):
        """Emit one node with a fresh output; returns its name."""
        return self.emit(op_type, inputs, [self.fresh(hint or op_type)],
                         attrs)

    # -- values and operands --

    @staticmethod
    def val(node):
        return node.meta['val']

    def dtype_of(self, a):
        return self.val(a).dtype if isinstance(a, torch.fx.Node) else None

    def operand(self, a, dtype=None):
        """The ONNX name of argument `a` (an fx node or a Python number),
        as `dtype` when given."""
        if isinstance(a, torch.fx.Node):
            name = self.names[a]
            if dtype is not None and self.val(a).dtype != dtype:
                name = self.op('Cast', [name], {'to': _dt(dtype)}, 'cast')
            return name
        if isinstance(a, (bool, int, float)):
            if dtype is None:
                raise NotImplementedError(
                    'ONNX export: a scalar operand without a dtype')
            return self.const(a, dtype)
        raise NotImplementedError('ONNX export: operand %r' % (a,))

    @staticmethod
    def _meta(a):
        if isinstance(a, torch.fx.Node):
            v = a.meta['val']
            return torch.empty(v.shape, dtype=v.dtype, device='meta')
        return a

    def result_dtype(self, x, y):
        return torch.result_type(self._meta(x), self._meta(y))

    def is_known(self, node):
        return all(isinstance(self.names.get(a), str)
                   and self.names[a] in self.const_vals
                   for a in node.all_input_nodes)

    # -- the walk --

    def convert(self, program, in_names):
        from torch.export.graph_signature import InputKind
        specs = {s.arg.name: s for s in program.graph_signature.input_specs}
        state = dict(program.state_dict)
        state.update(program.constants)
        user = iter(in_names)
        outputs = None
        for node in program.graph.nodes:
            if node.op == 'placeholder':
                spec = specs[node.name]
                for v in _vals(self.val(node)):
                    _np_dtype(v.dtype)
                if spec.kind == InputKind.USER_INPUT:
                    self.names[node] = next(user)
                else:
                    self.names[node] = self.add_const(
                        self.fresh('w'), state[spec.target].detach())
            elif node.op == 'call_function':
                self.call(node)
            elif node.op == 'output':
                outputs = list(node.args[0])
        return outputs

    def call(self, node):
        target = node.target
        if target is operator.getitem:
            src, idx = node.args
            name = self.names[src][idx]
            if name is None:
                raise NotImplementedError(
                    'ONNX export: output %d of %s is not supported'
                    % (idx, src.target))
            self.names[node] = name
            return
        op = _op_name(target)
        short = op.split('.', 1)[1] if op.startswith('aten.') else op
        if short in _NO_OUTPUT:
            return
        if 'val' in node.meta:
            for v in _vals(self.val(node)):
                _np_dtype(v.dtype)
        # constant folding: every input statically known -> evaluate now
        if self.is_known(node):
            self.fold(node)
            return
        if short in _IDENTITY:
            handler = self._identity
        elif short in _UNARY:
            handler = self._unary
        elif short in _BINARY:
            handler = self._binary
        elif short in _COMPARE:
            handler = self._compare
        elif short in _LOGICAL:
            handler = self._logical
        elif op == _FLASH_FWD:
            handler = self._flash_fwd
        else:
            handler = getattr(self, '_a_' + short, None) \
                if op.startswith('aten.') else None
        if handler is None:
            raise NotImplementedError(
                'ONNX export: op %r is not supported; supported ops: %s. '
                'For full-fidelity export use paddle.jit.save '
                '(torch.export).' % (str(target), _supported_ops()))
        out = handler(node, short)
        if out is not None:
            self.names[node] = out

    def fold(self, node):
        def value(a):
            return self.const_vals[self.names[a]]
        args = torch.fx.node.map_arg(node.args, value)
        kwargs = torch.fx.node.map_arg(node.kwargs, value)
        with torch.no_grad():
            out = node.target(*args, **kwargs)
        if isinstance(out, (tuple, list)):
            self.names[node] = [
                self.add_const(self.fresh('c'), o)
                if isinstance(o, torch.Tensor) else None for o in out]
        else:
            self.names[node] = self.add_const(self.fresh('c'), out)

    # -- elementwise --

    def _identity(self, n, op):
        return self.op('Identity', [self.names[n.args[0]]])

    def _unary(self, n, op):
        return self.op(_UNARY[op], [self.operand(n.args[0],
                                                 self.val(n).dtype)])

    def _binary(self, n, op):
        dt = self.val(n).dtype
        x, y = n.args[:2]
        a, b = self.operand(x, dt), self.operand(y, dt)
        alpha = n.kwargs.get('alpha', n.args[2] if len(n.args) > 2 else 1)
        if alpha != 1:
            b = self.op('Mul', [b, self.const(alpha, dt)])
        return self.op(_BINARY[op], [a, b])

    def _compare(self, n, op):
        x, y = n.args[:2]
        dt = self.result_dtype(x, y)
        return self.op(_COMPARE[op], [self.operand(x, dt),
                                      self.operand(y, dt)])

    def _logical(self, n, op):
        if op.startswith('bitwise') and self.val(n).dtype != torch.bool:
            raise NotImplementedError(
                'ONNX export: %s on integers is not supported' % op)
        x, y = n.args[:2]
        return self.op(_LOGICAL[op], [self.operand(x, torch.bool),
                                      self.operand(y, torch.bool)])

    def _a_ne(self, n, op):
        return self.op('Not', [self._compare(n, 'eq')])

    def _a_bitwise_not(self, n, op):
        if self.val(n).dtype != torch.bool:
            raise NotImplementedError(
                'ONNX export: bitwise_not on integers is not supported')
        return self.op('Not', [self.names[n.args[0]]])

    def _a_div(self, n, op):
        dt = self.val(n).dtype
        x, y = n.args[:2]
        q = self.op('Div', [self.operand(x, dt), self.operand(y, dt)])
        mode = n.kwargs.get('rounding_mode')
        if mode is None or not dt.is_floating_point:
            if mode == 'floor' and not dt.is_floating_point:
                raise NotImplementedError(
                    'ONNX export: integer floor division is not supported')
            return q
        if mode == 'floor':
            return self.op('Floor', [q])
        # trunc: sign(q) * floor(|q|)
        return self.op('Mul', [self.op('Sign', [q]), self.op(
            'Floor', [self.op('Abs', [q])])])

    def _a_pow(self, n, op):
        dt = self.val(n).dtype
        x, y = n.args[:2]
        if isinstance(y, (int, float)) and y == 2:
            a = self.operand(x, dt)
            return self.op('Mul', [a, a])
        return self.op('Pow', [self.operand(x, dt), self.operand(y, dt)])

    def _a_reciprocal(self, n, op):
        dt = self.val(n).dtype
        return self.op('Div', [self.const(1, dt),
                               self.operand(n.args[0], dt)])

    def _a_rsqrt(self, n, op):
        dt = self.val(n).dtype
        return self.op('Div', [self.const(1, dt), self.op(
            'Sqrt', [self.operand(n.args[0], dt)])])

    def _a_relu(self, n, op):
        dt = self.val(n).dtype
        return self.op('Max', [self.operand(n.args[0], dt),
                               self.const(0, dt)])

    def _a_clamp(self, n, op):
        dt = self.val(n).dtype
        out = self.operand(n.args[0], dt)
        lo = n.args[1] if len(n.args) > 1 else n.kwargs.get('min')
        hi = n.args[2] if len(n.args) > 2 else n.kwargs.get('max')
        if lo is not None:
            out = self.op('Max', [out, self.operand(lo, dt)])
        if hi is not None:
            out = self.op('Min', [out, self.operand(hi, dt)])
        return out

    def _a_where(self, n, op):
        dt = self.val(n).dtype
        c, x, y = n.args[:3]
        return self.op('Where', [self.operand(c, torch.bool),
                                 self.operand(x, dt), self.operand(y, dt)])

    def _a__to_copy(self, n, op):
        x = n.args[0]
        dt = self.val(n).dtype
        if self.val(x).dtype == dt:
            return self.op('Identity', [self.names[x]])
        return self.op('Cast', [self.names[x]], {'to': _dt(dt)}, 'cast')

    def _a_gelu(self, n, op):
        dt = self.val(n).dtype
        x = self.operand(n.args[0], dt)
        half = self.op('Mul', [x, self.const(0.5, dt)])
        if n.kwargs.get('approximate', 'none') == 'tanh':
            cube = self.op('Mul', [self.op('Mul', [x, x]), x])
            inner = self.op('Add', [x, self.op('Mul', [
                cube, self.const(0.044715, dt)])])
            t = self.op('Tanh', [self.op('Mul', [
                inner, self.const(float(np.sqrt(2.0 / np.pi)), dt)])])
        else:
            t = self.op('Erf', [self.op('Mul', [
                x, self.const(float(1.0 / np.sqrt(2.0)), dt)])])
        return self.op('Mul', [half, self.op('Add', [t, self.const(1, dt)])])

    # -- shape ops --

    def _reshape(self, n):
        return self.op('Reshape', [self.names[n.args[0]], self.ints(
            self.val(n).shape, 'shape')])

    def _a_view(self, n, op):
        return self._reshape(n)

    def _a_permute(self, n, op):
        rank = self.val(n).dim()
        return self.op('Transpose', [self.names[n.args[0]]],
                       {'perm': [int(d) % rank for d in n.args[1]]})

    def _a_unsqueeze(self, n, op):
        ax = int(n.args[1]) % self.val(n).dim()
        return self.op('Unsqueeze', [self.names[n.args[0]],
                                     self.ints([ax], 'axes')])

    def _a_squeeze(self, n, op):
        x = n.args[0]
        shape = self.val(x).shape
        rank = len(shape)
        if len(n.args) > 1:
            dims = n.args[1] if isinstance(n.args[1], (list, tuple)) \
                else [n.args[1]]
            dims = [int(d) % rank for d in dims if shape[int(d) % rank] == 1]
        else:
            dims = [d for d in range(rank) if shape[d] == 1]
        if not dims:
            return self.op('Identity', [self.names[x]])
        return self.op('Squeeze', [self.names[x], self.ints(dims, 'axes')])

    def _a_expand(self, n, op):
        return self.op('Expand', [self.names[n.args[0]], self.ints(
            self.val(n).shape, 'shape')])

    def _slice(self, x, dim, start, end, step=1):
        size = self.val(x).shape[dim]
        start = 0 if start is None else int(start)
        end = size if end is None else min(int(end), size)
        names = [self.ints([v], hint) for hint, v in (
            ('starts', start), ('ends', end), ('axes', dim),
            ('steps', step))]
        return self.op('Slice', [self.names[x]] + names)

    def _a_slice(self, n, op):
        x = n.args[0]
        args = list(n.args[1:]) + [None] * (4 - len(n.args[1:]))
        dim, start, end, step = args
        dim = int(dim or 0) % self.val(x).dim()
        return self._slice(x, dim, start, end, 1 if step is None else step)

    def _a_select(self, n, op):
        # Slice then Squeeze: the writer stores a 0-d constant as [1]
        # (np.ascontiguousarray), so a Gather index would keep the axis
        x, dim, index = n.args
        dim = int(dim) % self.val(x).dim()
        index = int(index) % self.val(x).shape[dim]
        return self.op('Squeeze', [self._slice(x, dim, index, index + 1),
                                   self.ints([dim], 'axes')])

    def _a_split_with_sizes(self, n, op):
        x, sizes = n.args[:2]
        dim = int(n.args[2] if len(n.args) > 2 else 0) % self.val(x).dim()
        outs, start = [], 0
        for size in sizes:
            outs.append(self._slice(x, dim, start, start + int(size)))
            start += int(size)
        return outs

    def _a_cat(self, n, op):
        dt = self.val(n).dtype
        dim = n.args[1] if len(n.args) > 1 else 0
        xs = [a for a in n.args[0] if self.val(a).numel() or
              self.val(a).dim() > 1]
        return self.op('Concat', [self.operand(a, dt) for a in xs],
                       {'axis': int(dim) % self.val(n).dim()})

    def _a_index(self, n, op):
        x, indices = n.args
        picked = [(i, t) for i, t in enumerate(indices) if t is not None]
        if len(picked) != 1 or self.val(picked[0][1]).dtype == torch.bool:
            raise NotImplementedError(
                'ONNX export: general indexing (only a take along one '
                'axis with an integer index tensor is supported)')
        axis, idx = picked[0]
        return self.op('Gather', [self.names[x], self.names[idx]],
                       {'axis': axis})

    def _dims(self, x, dims):
        rank = self.val(x).dim()
        if dims is None or (isinstance(dims, (list, tuple)) and not dims):
            return list(range(rank))
        if not isinstance(dims, (list, tuple)):
            dims = [dims]
        return [int(d) % max(rank, 1) for d in dims]

    def _reduce(self, op_type, x, axes, keepdims):
        attrs = {'keepdims': int(bool(keepdims))}
        if self.opset >= 18 or op_type == 'ReduceSum':
            return self.op(op_type, [x, self.ints(axes, 'axes')], attrs)
        attrs['axes'] = [int(a) for a in axes]
        return self.op(op_type, [x], attrs)

    def _a_sum(self, n, op):
        x = n.args[0]
        dims = self._dims(x, n.args[1] if len(n.args) > 1 else None)
        keep = n.args[2] if len(n.args) > 2 else n.kwargs.get('keepdim',
                                                               False)
        return self._reduce('ReduceSum', self.operand(x, self.val(n).dtype),
                            dims, keep)

    def _a_mean(self, n, op):
        x = n.args[0]
        dt = self.val(n).dtype
        dims = self._dims(x, n.args[1] if len(n.args) > 1 else None)
        keep = n.args[2] if len(n.args) > 2 else n.kwargs.get('keepdim',
                                                               False)
        count = int(np.prod([self.val(x).shape[d] for d in dims]))
        s = self._reduce('ReduceSum', self.operand(x, dt), dims, keep)
        return self.op('Div', [s, self.const(count, dt)])

    def _minmax(self, n, op_type):
        x = n.args[0]
        dims = self._dims(x, n.args[1] if len(n.args) > 1 else None)
        keep = n.args[2] if len(n.args) > 2 else n.kwargs.get('keepdim',
                                                               False)
        return self._reduce(op_type, self.names[x], dims, keep)

    def _a_amax(self, n, op):
        return self._minmax(n, 'ReduceMax')

    def _a_amin(self, n, op):
        return self._minmax(n, 'ReduceMin')

    def _a_argmax(self, n, op):
        x = self.names[n.args[0]]
        dim = n.args[1] if len(n.args) > 1 else n.kwargs.get('dim')
        keep = n.args[2] if len(n.args) > 2 else n.kwargs.get('keepdim',
                                                               False)
        if dim is None:
            x = self.op('Reshape', [x, self.ints([-1], 'shape')])
            dim = 0
        dim = int(dim) % max(self.val(n.args[0]).dim(), 1)
        return self.op('ArgMax', [x], {'axis': dim,
                                       'keepdims': int(bool(keep))})

    def _a_max(self, n, op):
        if len(n.args) < 2:
            return self._minmax(n, 'ReduceMax')
        x, dim = n.args[:2]
        keep = n.args[2] if len(n.args) > 2 else False
        dim = int(dim) % self.val(x).dim()
        return [self._reduce('ReduceMax', self.names[x], [dim], keep),
                self.op('ArgMax', [self.names[x]],
                        {'axis': dim, 'keepdims': int(bool(keep))})]

    # -- normalisations (as the JAX jaxprs write them) --

    def _softmax_parts(self, x, axis):
        mx = self._reduce('ReduceMax', x, [axis], True)
        shifted = self.op('Sub', [x, mx])
        e = self.op('Exp', [shifted])
        return shifted, e, self._reduce('ReduceSum', e, [axis], True)

    def _a__softmax(self, n, op):
        x, dim = n.args[:2]
        dt = self.val(n).dtype
        axis = int(dim) % self.val(x).dim()
        _, e, s = self._softmax_parts(self.operand(x, dt), axis)
        return self.op('Div', [e, s])

    def _a__log_softmax(self, n, op):
        x, dim = n.args[:2]
        dt = self.val(n).dtype
        axis = int(dim) % self.val(x).dim()
        shifted, _, s = self._softmax_parts(self.operand(x, dt), axis)
        return self.op('Sub', [shifted, self.op('Log', [s])])

    def _moments(self, x, axes, dt, count):
        inv = self.const(1.0 / count, dt)
        mean = self.op('Mul', [self._reduce('ReduceSum', x, axes, True),
                               inv])
        centred = self.op('Sub', [x, mean])
        var = self.op('Mul', [self._reduce(
            'ReduceSum', self.op('Mul', [centred, centred]), axes, True),
            inv])
        return mean, centred, var

    def _a_native_layer_norm(self, n, op):
        x, shape, w, b, eps = n.args
        dt = self.val(n)[0].dtype
        rank = self.val(x).dim()
        axes = list(range(rank - len(shape), rank))
        count = int(np.prod(shape))
        mean, centred, var = self._moments(self.operand(x, dt), axes, dt,
                                           count)
        rstd = self.op('Div', [self.const(1, dt), self.op('Sqrt', [
            self.op('Add', [var, self.const(float(eps), dt)])])])
        out = self.op('Mul', [centred, rstd])
        if w is not None:
            out = self.op('Mul', [out, self.operand(w, dt)])
        if b is not None:
            out = self.op('Add', [out, self.operand(b, dt)])
        return [out, mean, rstd]

    def _a__native_batch_norm_legit_no_training(self, n, op):
        x, w, b, mean, var, _, eps = n.args
        dt = self.val(n)[0].dtype
        rank = self.val(x).dim()
        shape = [-1] + [1] * (rank - 2)

        def chan(a):
            return self.op('Reshape', [self.operand(a, dt),
                                       self.ints(shape, 'shape')])
        rstd = self.op('Div', [self.const(1, dt), self.op('Sqrt', [
            self.op('Add', [chan(var), self.const(float(eps), dt)])])])
        out = self.op('Mul', [self.op('Sub', [self.operand(x, dt),
                                              chan(mean)]), rstd])
        if w is not None:
            out = self.op('Mul', [out, chan(w)])
        if b is not None:
            out = self.op('Add', [out, chan(b)])
        return [out, None, None]

    # -- linear algebra, convolutions, pools --

    def _matmul(self, n, op):
        dt = self.val(n).dtype
        return self.op('MatMul', [self.operand(n.args[0], dt),
                                  self.operand(n.args[1], dt)])

    _a_mm = _a_bmm = _matmul

    def _a_addmm(self, n, op):
        dt = self.val(n).dtype
        bias, a, b = n.args[:3]
        beta = n.kwargs.get('beta', 1)
        alpha = n.kwargs.get('alpha', 1)
        prod = self.op('MatMul', [self.operand(a, dt), self.operand(b, dt)])
        if alpha != 1:
            prod = self.op('Mul', [prod, self.const(alpha, dt)])
        bias = self.operand(bias, dt)
        if beta != 1:
            bias = self.op('Mul', [bias, self.const(beta, dt)])
        return self.op('Add', [prod, bias])

    def _a_convolution(self, n, op):
        (x, w, b, stride, padding, dilation, transposed, _,
         groups) = n.args
        if transposed:
            raise NotImplementedError(
                'ONNX export: transposed convolution is not supported — '
                'use ConvTranspose layers via jit.save')
        ins = [self.names[x], self.names[w]]
        if b is not None:
            ins.append(self.names[b])
        return self.op('Conv', ins, {
            'strides': [int(s) for s in stride],
            'dilations': [int(d) for d in dilation],
            'pads': [int(p) for p in padding] * 2,
            'group': int(groups)})

    def _pool_attrs(self, x, kernel, stride, padding, ceil_mode):
        spatial = self.val(x).dim() - 2

        def per_dim(v, default):
            v = list(v) if isinstance(v, (list, tuple)) and v else default
            return [int(s) for s in (v * spatial if len(v) == 1 else v)]
        attrs = {'kernel_shape': per_dim(kernel, None),
                 'strides': per_dim(stride, list(kernel)),
                 'pads': per_dim(padding, [0]) * 2}
        if ceil_mode:
            attrs['ceil_mode'] = 1
        return attrs

    def _a_max_pool2d_with_indices(self, n, op):
        args = list(n.args) + [None] * (6 - len(n.args))
        x, kernel, stride, padding, dilation, ceil_mode = args
        if dilation and any(int(d) != 1 for d in dilation):
            raise NotImplementedError(
                'ONNX export: dilated max pooling is not supported')
        return [self.op('MaxPool', [self.names[x]], self._pool_attrs(
            x, kernel, stride, padding or [0], ceil_mode)), None]

    def _a_avg_pool2d(self, n, op):
        args = list(n.args) + [None] * (7 - len(n.args))
        x, kernel, stride, padding, ceil_mode, include, divisor = args
        if divisor:
            raise NotImplementedError(
                'ONNX export: avg_pool divisor_override is not supported')
        attrs = self._pool_attrs(x, kernel, stride, padding or [0],
                                 ceil_mode)
        attrs['count_include_pad'] = int(include is None or bool(include))
        return self.op('AveragePool', [self.names[x]], attrs)

    def _flash_fwd(self, n, op):
        """flash_attention_fwd_ref in ONNX ops: s = (q k^T) * scale in
        f32, the top-left causal mask as a constant, exp(s - max) summed,
        o = (p @ v) / l, lse = max + log(l)."""
        q, k, v, causal, scale = n.args
        f32 = torch.float32
        qv, kv, vv = self.val(q), self.val(k), self.val(v)
        qf, kf, vf = (self.operand(a, f32) for a in (q, k, v))
        kt = self.op('Transpose', [kf], {'perm': [0, 1, 3, 2]})
        s = self.op('Mul', [self.op('MatMul', [qf, kt]),
                            self.const(float(scale), f32, 'scale')])
        if causal:
            nq, nk = qv.shape[2], kv.shape[2]
            keep = torch.ones(nq, nk, dtype=torch.bool).tril()
            from .ops.flash_attention import _NEG_INF
            s = self.op('Where', [self.add_const(self.fresh('causal'), keep),
                                  s, self.const(_NEG_INF, f32)])
        mx = self._reduce('ReduceMax', s, [3], True)
        p = self.op('Exp', [self.op('Sub', [s, mx])])
        l_safe = self.op('Max', [self._reduce('ReduceSum', p, [3], True),
                                 self.const(1e-30, f32)])
        if vv.dtype != f32:
            p = self.op('Cast', [self.op('Cast', [p], {'to': _dt(vv.dtype)},
                                         'cast')], {'to': _dt(f32)}, 'cast')
        o = self.op('Div', [self.op('MatMul', [p, vf]), l_safe])
        if qv.dtype != f32:
            o = self.op('Cast', [o], {'to': _dt(qv.dtype)}, 'cast')
        lse = self.op('Add', [mx, self.op('Log', [l_safe])])
        self.flash_lowered += 1
        return [o, lse]


def _supported_ops():
    """The ops the converter handles, sorted, as the refusal lists them."""
    names = set(_IDENTITY) | set(_UNARY) | set(_BINARY) | set(_COMPARE) | \
        set(_LOGICAL)
    names |= {m[3:] for m in dir(_Converter) if m.startswith('_a_')}
    return sorted('aten.' + m for m in names) + [_FLASH_FWD]


def export(layer, path, input_spec=None, opset_version=13, **configs):
    """Convert `layer`'s eval-mode forward to ONNX and write <path>.onnx;
    returns the file's path.

    input_spec: list of InputSpec / tensors describing the inputs
    (required: ONNX graphs are shape-typed). The forward is traced on the
    model's device (the card unless the model is on the CPU). Raises
    ValueError on a shape that is not fully static and NotImplementedError
    on an op or a dtype outside the supported conversion set.
    `export.stats` holds the last export's node, initializer and lowered
    flash counts."""
    from .framework import device as device_mod
    from .framework import dtype as dtype_mod
    from .jit import _plain_eval
    from .static.input_spec import InputSpec

    if not input_spec:
        raise ValueError('paddle.onnx.export requires input_spec')
    specs = [s if isinstance(s, InputSpec) else InputSpec.from_tensor(s)
             for s in input_spec]
    for i, s in enumerate(specs):
        if any(d is None or int(d) < 0 for d in s.shape):
            raise ValueError(
                'ONNX export requires fully static input shapes (the graph '
                'bakes shape constants); input_spec[%d] has %r — export one '
                'model per concrete shape' % (i, tuple(s.shape)))
    dtypes = [dtype_mod.torch_dtype(s.dtype) for s in specs]
    for dt in dtypes:
        _np_dtype(dt)
    weights = list(layer.parameters()) + list(layer.buffers())
    dev = weights[0].device if weights else device_mod.resolve()
    examples = tuple(torch.zeros(tuple(int(d) for d in s.shape), dtype=dt,
                                 device=dev)
                     for s, dt in zip(specs, dtypes))
    with _plain_eval(layer), torch.no_grad():
        program = torch.export.export(layer, examples, strict=False)
        program = program.run_decompositions()

    in_names = [s.name or 'input_%d' % i for i, s in enumerate(specs)]
    conv = _Converter(opset_version)
    with torch.no_grad():
        outputs = conv.convert(program, in_names)

    # outputs that were fully constant-folded are initializer-backed
    # Identity outputs, as the JAX exporter writes them
    final_outs = []
    for idx, node in enumerate(outputs):
        onm = 'output_%d' % idx
        conv.emit('Identity', [conv.names[node]], [onm])
        val = node.meta['val']
        final_outs.append((onm, tuple(int(d) for d in val.shape),
                           _np_dtype(val.dtype)))

    # initializers: the known values a node reads, copied to the host
    used = {i for _, ins, _, _, _ in conv.nodes for i in ins}
    inits = {nm: v.detach().cpu().numpy()
             for nm, v in conv.const_vals.items() if nm in used}
    # the graph's fields joined once (appending each to a growing bytes
    # object copies the initializers again for every one)
    parts = [_f_bytes(1, _node(*node[:4], name=node[4]))
             for node in conv.nodes]
    parts.append(_f_bytes(2, 'paddle_tpu_torch_graph'))
    parts += [_f_bytes(5, _tensor_proto(nm, arr))
              for nm, arr in inits.items()]
    parts += [_f_bytes(11, _value_info(nm, tuple(int(d) for d in s.shape),
                                       _np_dtype(dt)))
              for nm, s, dt in zip(in_names, specs, dtypes)]
    parts += [_f_bytes(12, _value_info(onm, shape, dtype))
              for onm, shape, dtype in final_outs]
    model = _model_proto(b''.join(parts), opset_version)
    out_path = path if path.endswith('.onnx') else path + '.onnx'
    with open(out_path, 'wb') as f:
        f.write(model)
    export.stats = {'nodes': len(conv.nodes), 'initializers': len(inits),
                    'initializer_bytes': sum(a.nbytes
                                             for a in inits.values()),
                    'flash_lowered': conv.flash_lowered,
                    'bytes': len(model)}
    return out_path


export.stats = {}
