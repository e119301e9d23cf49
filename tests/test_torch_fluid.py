"""The port's reference-format loader (paddle_tpu_torch/inference/
fluid_program.py) against the JAX package's.

Each test writes a byte-genuine reference-format model — a `__model__`
ProgramDesc protobuf (framework.proto:202) and LoDTensor params
(lod_tensor.cc:244 SerializeToStream) — with this file's own proto2 /
LoDTensor writer (a copy of tests/test_fluid_interop.py's), then feeds the
same artifact and the same inputs through both packages'
load_fluid_model(...).run and Predictor, within 1e-5: fit_a_line in both
layouts, the digits CNN, word2vec, an extended op table (one program over
most of the table's entries), reshape -1 / decrease_axis, the parser round
trip of negative and typed attrs, the trailing-byte guard, Executor +
load_inference_model on a reference directory, and a bf16 LoDTensor read
without ml_dtypes. The detection ops run (yolo_box, the anchor ops and
box_coder here; the NMS and roi_align programs in test_torch_yolo.py)
and keep the JAX table's two refusals.

The port compiles each block with Inductor on the CPU (one compile thread);
the JAX side runs jax.jit.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import builtins
import os
import struct

import numpy as np
import pytest
import torch
import torch._inductor.config as inductor_config

from paddle_tpu import inference as jinf
from paddle_tpu.inference import fluid_program as jfp
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.inference import fluid_program as tfp

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setattr(inductor_config, 'compile_threads', 1)


# -- independent proto2 wire writer ------------------------------------------

def _varint(v):
    if v < 0:
        v += 1 << 64  # two's complement (proto2 int32/int64 negatives)
    out = b''
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _tag(field, wire):
    return _varint((field << 3) | wire)


def _len_field(field, payload):
    return _tag(field, 2) + _varint(len(payload)) + payload


def _vint_field(field, v):
    return _tag(field, 0) + _varint(v)


def _f32_field(field, v):
    return _tag(field, 5) + struct.pack('<f', v)


def _str_field(field, s):
    return _len_field(field, s.encode())


def _attr(name, atype, value):
    out = _str_field(1, name) + _vint_field(2, atype)
    if atype == 0:      # INT
        out += _vint_field(3, value)
    elif atype == 1:    # FLOAT
        out += _f32_field(4, value)
    elif atype == 2:    # STRING
        out += _str_field(5, value)
    elif atype == 3:    # INTS (proto2 default: unpacked)
        for v in value:
            out += _vint_field(6, v)
    elif atype == 4:    # FLOATS
        for v in value:
            out += _f32_field(7, v)
    elif atype == 6:    # BOOLEAN
        out += _vint_field(10, 1 if value else 0)
    elif atype == 11:   # LONGS
        for v in value:
            out += _vint_field(15, v)
    else:
        raise ValueError(atype)
    return out


def _op(op_type, inputs, outputs, attrs=()):
    out = b''
    for param, args in inputs:
        var = _str_field(1, param)
        for a in args:
            var += _str_field(2, a)
        out += _len_field(1, var)
    for param, args in outputs:
        var = _str_field(1, param)
        for a in args:
            var += _str_field(2, a)
        out += _len_field(2, var)
    out += _str_field(3, op_type)
    for a in attrs:
        out += _len_field(4, _attr(*a))
    return out


_FP32 = 5


def _tensor_desc(dtype, dims):
    out = _vint_field(1, dtype)
    for d in dims:
        out += _vint_field(2, d)
    return out


def _var(name, dims=None, vtype=7, dtype=_FP32, persistable=False):
    """vtype 7 = LOD_TENSOR, 9 = FEED_MINIBATCH, 10 = FETCH_LIST."""
    vt = _vint_field(1, vtype)
    if dims is not None:
        lod = _len_field(1, _tensor_desc(dtype, dims)) + _vint_field(2, 0)
        vt += _len_field(3, lod)
    out = _str_field(1, name) + _len_field(2, vt)
    if persistable:
        out += _vint_field(3, 1)
    return out


def _block(variables, ops, idx=0, parent=-1):
    out = _vint_field(1, idx) + _vint_field(2, parent)
    for v in variables:
        out += _len_field(3, v)
    for o in ops:
        out += _len_field(4, o)
    return out


def _program(blocks):
    out = b''
    for b in blocks:
        out += _len_field(1, b)
    out += _len_field(4, _vint_field(1, 0))  # Version{version=0}
    return out


def _write_lod_tensor(f, arr, dtype=_FP32):
    """lod_tensor.cc SerializeToStream: u32 ver, u64 lod levels, then
    tensor_util.cc TensorToStream: u32 ver, i32 desc size, desc, data.
    `arr` holds the values' bytes (bf16 as its uint16 bits)."""
    f.write(struct.pack('<I', 0))
    f.write(struct.pack('<Q', 0))
    desc = _tensor_desc(dtype, arr.shape)
    f.write(struct.pack('<I', 0))
    f.write(struct.pack('<i', len(desc)))
    f.write(desc)
    f.write(np.ascontiguousarray(arr).tobytes())


# -- model builders -----------------------------------------------------------

def _fit_a_line_dir(tmp_path, combined):
    rng = np.random.RandomState(0)
    w = rng.randn(13, 1).astype(np.float32)
    b = rng.randn(1).astype(np.float32)

    variables = [
        _var('feed', vtype=9, persistable=True),
        _var('fetch', vtype=10, persistable=True),
        _var('x', dims=[-1, 13]),
        _var('fc_w', dims=[13, 1], persistable=True),
        _var('fc_b', dims=[1], persistable=True),
        _var('fc_tmp', dims=[-1, 1]),
        _var('out', dims=[-1, 1]),
    ]
    ops = [
        _op('feed', [('X', ['feed'])], [('Out', ['x'])],
            [('col', 0, 0)]),
        _op('mul', [('X', ['x']), ('Y', ['fc_w'])],
            [('Out', ['fc_tmp'])],
            [('x_num_col_dims', 0, 1), ('y_num_col_dims', 0, 1)]),
        _op('elementwise_add', [('X', ['fc_tmp']), ('Y', ['fc_b'])],
            [('Out', ['out'])], [('axis', 0, 1)]),
        _op('fetch', [('X', ['out'])], [('Out', ['fetch'])],
            [('col', 0, 0)]),
    ]
    d = tmp_path / ('fit_a_line_comb' if combined else 'fit_a_line')
    d.mkdir()
    (d / '__model__').write_bytes(_program([_block(variables, ops)]))
    params = {'fc_w': w, 'fc_b': b}
    if combined:
        with open(d / '__params__', 'wb') as f:
            for name in sorted(params):
                _write_lod_tensor(f, params[name])
    else:
        for name, arr in params.items():
            with open(d / name, 'wb') as f:
                _write_lod_tensor(f, arr)
    return d, w, b


def _digits_cnn_dir(tmp_path):
    """recognize_digits-style: conv2d -> batch_norm -> relu -> pool2d ->
    flatten -> fc(mul+add) -> softmax."""
    rng = np.random.RandomState(1)
    conv_w = (rng.randn(4, 1, 3, 3) * 0.5).astype(np.float32)
    bn_scale = rng.rand(4).astype(np.float32) + 0.5
    bn_bias = rng.randn(4).astype(np.float32)
    bn_mean = rng.randn(4).astype(np.float32) * 0.1
    bn_var = rng.rand(4).astype(np.float32) + 0.5
    fc_w = (rng.randn(4 * 13 * 13, 10) * 0.1).astype(np.float32)
    fc_b = rng.randn(10).astype(np.float32)

    variables = [
        _var('feed', vtype=9, persistable=True),
        _var('fetch', vtype=10, persistable=True),
        _var('img', dims=[-1, 1, 28, 28]),
        _var('conv_w', dims=[4, 1, 3, 3], persistable=True),
        _var('bn_scale', dims=[4], persistable=True),
        _var('bn_bias', dims=[4], persistable=True),
        _var('bn_mean', dims=[4], persistable=True),
        _var('bn_var', dims=[4], persistable=True),
        _var('fc_w', dims=[4 * 13 * 13, 10], persistable=True),
        _var('fc_b', dims=[10], persistable=True),
        _var('conv_out', dims=[-1, 4, 26, 26]),
        _var('bn_out', dims=[-1, 4, 26, 26]),
        _var('relu_out', dims=[-1, 4, 26, 26]),
        _var('pool_out', dims=[-1, 4, 13, 13]),
        _var('flat_out', dims=[-1, 4 * 13 * 13]),
        _var('fc_tmp', dims=[-1, 10]),
        _var('fc_out', dims=[-1, 10]),
        _var('prob', dims=[-1, 10]),
    ]
    ops = [
        _op('feed', [('X', ['feed'])], [('Out', ['img'])], [('col', 0, 0)]),
        _op('conv2d', [('Input', ['img']), ('Filter', ['conv_w'])],
            [('Output', ['conv_out'])],
            [('strides', 3, [1, 1]), ('paddings', 3, [0, 0]),
             ('dilations', 3, [1, 1]), ('groups', 0, 1)]),
        _op('batch_norm',
            [('X', ['conv_out']), ('Scale', ['bn_scale']),
             ('Bias', ['bn_bias']), ('Mean', ['bn_mean']),
             ('Variance', ['bn_var'])],
            [('Y', ['bn_out'])],
            [('epsilon', 1, 1e-5), ('is_test', 6, True)]),
        _op('relu', [('X', ['bn_out'])], [('Out', ['relu_out'])]),
        _op('pool2d', [('X', ['relu_out'])], [('Out', ['pool_out'])],
            [('pooling_type', 2, 'max'), ('ksize', 3, [2, 2]),
             ('strides', 3, [2, 2]), ('paddings', 3, [0, 0])]),
        _op('flatten_contiguous_range', [('X', ['pool_out'])],
            [('Out', ['flat_out'])],
            [('start_axis', 0, 1), ('stop_axis', 0, -1)]),
        _op('mul', [('X', ['flat_out']), ('Y', ['fc_w'])],
            [('Out', ['fc_tmp'])],
            [('x_num_col_dims', 0, 1), ('y_num_col_dims', 0, 1)]),
        _op('elementwise_add', [('X', ['fc_tmp']), ('Y', ['fc_b'])],
            [('Out', ['fc_out'])], [('axis', 0, 1)]),
        _op('softmax', [('X', ['fc_out'])], [('Out', ['prob'])],
            [('axis', 0, -1)]),
        _op('fetch', [('X', ['prob'])], [('Out', ['fetch'])],
            [('col', 0, 0)]),
    ]
    d = tmp_path / 'digits'
    d.mkdir()
    (d / '__model__').write_bytes(_program([_block(variables, ops)]))
    params = {'conv_w': conv_w, 'bn_scale': bn_scale, 'bn_bias': bn_bias,
              'bn_mean': bn_mean, 'bn_var': bn_var, 'fc_w': fc_w,
              'fc_b': fc_b}
    for name, arr in params.items():
        with open(d / name, 'wb') as f:
            _write_lod_tensor(f, arr)
    return d, params




def _word2vec_dir(tmp_path):
    """The word2vec book-test graph (test_word2vec_book.py shape): four
    context words share ONE embedding table (lookup_table_v2), concat,
    fc, softmax over the vocab."""
    rng = np.random.RandomState(7)
    vocab, emb, n_ctx = 50, 8, 4
    table = rng.randn(vocab, emb).astype(np.float32)
    fc_w = rng.randn(n_ctx * emb, vocab).astype(np.float32)
    fc_b = rng.randn(vocab).astype(np.float32)

    int64 = 3
    variables = [
        _var('feed', vtype=9, persistable=True),
        _var('fetch', vtype=10, persistable=True),
        _var('emb_table', dims=[vocab, emb], persistable=True),
        _var('fc_w', dims=[n_ctx * emb, vocab], persistable=True),
        _var('fc_b', dims=[vocab], persistable=True),
        _var('cat', dims=[-1, n_ctx * emb]),
        _var('fc_tmp', dims=[-1, vocab]),
        _var('logits', dims=[-1, vocab]),
        _var('prob', dims=[-1, vocab]),
    ]
    ops = []
    for i in range(n_ctx):
        variables.append(_var('w%d' % i, dims=[-1], dtype=int64))
        variables.append(_var('emb%d' % i, dims=[-1, emb]))
        ops.append(_op('feed', [('X', ['feed'])], [('Out', ['w%d' % i])],
                       [('col', 0, i)]))
    for i in range(n_ctx):
        ops.append(_op('lookup_table_v2',
                       [('Ids', ['w%d' % i]), ('W', ['emb_table'])],
                       [('Out', ['emb%d' % i])]))
    ops += [
        _op('concat', [('X', ['emb%d' % i for i in range(n_ctx)])],
            [('Out', ['cat'])], [('axis', 0, 1)]),
        _op('mul', [('X', ['cat']), ('Y', ['fc_w'])],
            [('Out', ['fc_tmp'])],
            [('x_num_col_dims', 0, 1), ('y_num_col_dims', 0, 1)]),
        _op('elementwise_add', [('X', ['fc_tmp']), ('Y', ['fc_b'])],
            [('Out', ['logits'])], [('axis', 0, 1)]),
        _op('softmax', [('X', ['logits'])], [('Out', ['prob'])],
            [('axis', 0, -1)]),
        _op('fetch', [('X', ['prob'])], [('Out', ['fetch'])],
            [('col', 0, 0)]),
    ]
    d = tmp_path / 'word2vec'
    d.mkdir()
    (d / '__model__').write_bytes(_program([_block(variables, ops)]))
    for name, arr in (('emb_table', table), ('fc_w', fc_w),
                      ('fc_b', fc_b)):
        with open(d / name, 'wb') as f:
            _write_lod_tensor(f, arr)
    return d


def _write_model(tmp_path, name, variables, ops, params=None):
    d = tmp_path / name
    d.mkdir()
    (d / '__model__').write_bytes(_program([_block(variables, ops)]))
    for pname, arr in (params or {}).items():
        with open(d / pname, 'wb') as f:
            _write_lod_tensor(f, arr)
    return d


def _feed_fetch(feeds, fetches):
    """The feed / fetch vars and ops of a program."""
    variables = [_var('feed', vtype=9, persistable=True),
                 _var('fetch', vtype=10, persistable=True)]
    ops = [_op('feed', [('X', ['feed'])], [('Out', [n])], [('col', 0, i)])
           for i, n in enumerate(feeds)]
    tail = [_op('fetch', [('X', [n])], [('Out', ['fetch'])], [('col', 0, i)])
            for i, n in enumerate(fetches)]
    return variables, ops, tail


def _unary(op, x, out, attrs=()):
    return _op(op, [('X', [x])], [('Out', [out])], list(attrs))


def _binary(op, x, y, out, attrs=()):
    return _op(op, [('X', [x]), ('Y', [y])], [('Out', [out])], list(attrs))


# (op, attrs) applied to x [2, 4, 8, 8] one by one; each result is fetched
_UNARY = [
    ('relu', ()), ('sigmoid', ()), ('tanh', ()), ('exp', ()), ('square', ()),
    ('abs', ()), ('relu6', ()), ('hard_swish', ()), ('hard_sigmoid', ()),
    ('swish', ()), ('mish', ()), ('softplus', ()), ('log_softmax', ()),
    ('floor', ()), ('ceil', ()), ('round', ()), ('sign', ()),
    ('leaky_relu', [('alpha', 1, 0.1)]), ('gelu', [('approximate', 6, False)]),
    ('gelu', [('approximate', 6, True)]), ('elu', [('alpha', 1, 0.5)]),
    ('pow', [('factor', 1, 2.0)]),
    ('scale', [('scale', 1, 1.5), ('bias', 1, -0.5),
               ('bias_after_scale', 6, False)]),
    ('softmax', [('axis', 0, 1)]),
    ('dropout', [('dropout_prob', 1, 0.25)]),
    ('norm', [('axis', 0, 1), ('epsilon', 1, 1e-10)]),
    ('transpose2', [('axis', 3, [0, 2, 3, 1])]),
    ('flatten2', [('axis', 0, 2)]),
    ('reshape2', [('shape', 3, [-1, 32])]),
    ('squeeze2', [('axes', 3, [])]),
    ('unsqueeze2', [('axes', 3, [0, 3])]),
    ('tile', [('repeat_times', 3, [1, 2, 1, 1])]),
    ('expand_v2', [('shape', 3, [3, -1, -1, -1, -1])]),
    ('clip', [('min', 1, -0.5), ('max', 1, 0.5)]),
    ('cast', [('out_dtype', 0, 3)]),
    ('arg_max', [('axis', 0, 1)]),
    ('reduce_sum', [('dim', 3, [1, 2]), ('keep_dim', 6, False)]),
    ('reduce_max', [('reduce_all', 6, True)]),
    ('reduce_min', [('dim', 3, [-1]), ('keep_dim', 6, True)]),
    ('reduce_mean', [('dim', 3, [0, 3])]),
    ('reduce_prod', [('dim', 3, [3])]),
    ('mean', ()),
    ('pad2d', [('paddings', 3, [1, 0, 2, 1]), ('mode', 2, 'constant'),
               ('pad_value', 1, 0.5)]),
    ('pad3d', [('paddings', 3, [1, 2, 0, 1, 0, 0]), ('mode', 2, 'constant'),
               ('value', 1, -1.0)]),
    ('nearest_interp', [('out_h', 0, 5), ('out_w', 0, 11),
                        ('align_corners', 6, True)]),
    ('bilinear_interp_v2', [('out_h', 0, 13), ('out_w', 0, 6)]),
    ('bilinear_interp_v2', [('out_h', 0, 16), ('out_w', 0, 12),
                            ('align_mode', 0, 0)]),
    ('pool2d', [('pooling_type', 2, 'avg'), ('ksize', 3, [3, 3]),
                ('strides', 3, [2, 2]), ('paddings', 3, [1, 1]),
                ('exclusive', 6, True)]),
    ('pool2d', [('pooling_type', 2, 'avg'), ('ksize', 3, [2, 2]),
                ('strides', 3, [1, 1]), ('paddings', 3, [1, 1]),
                ('exclusive', 6, False)]),
    ('pool2d', [('pooling_type', 2, 'max'), ('ksize', 3, [3, 3]),
                ('strides', 3, [2, 2]), ('paddings', 3, [1, 1])]),
    ('pool2d', [('pooling_type', 2, 'max'), ('global_pooling', 6, True)]),
    ('pool2d', [('pooling_type', 2, 'avg'), ('adaptive', 6, True),
                ('ksize', 3, [1, 1])]),
]
# (op, attrs) of x and y [2, 4, 8, 8] (y [4] with axis 1)
_BINARY = [
    ('elementwise_add', [('axis', 0, 1)]), ('elementwise_sub', ()),
    ('elementwise_mul', ()), ('elementwise_div', ()),
    ('elementwise_max', ()), ('elementwise_min', ()),
    ('elementwise_floordiv', ()), ('elementwise_mod', ()),
    ('equal', ()), ('not_equal', ()), ('greater_than', ()),
    ('greater_equal', ()), ('less_than', ()), ('less_equal', ()),
]


def _table_dir(tmp_path):
    """One program over most of the op table: the unary and binary entries
    above on x, then conv2d (SAME, stride 2, and depthwise with explicit
    pads), batch_norm, layer_norm, instance_norm, prelu, mul, matmul,
    matmul_v2, fc, split / concat / stack, slice, shape, fill_constant,
    one_hot_v2 and lookup_table on the ids."""
    rng = np.random.RandomState(11)
    params = {
        'y_full': rng.rand(2, 4, 8, 8).astype(np.float32) + 0.5,
        'y_ch': rng.randn(4).astype(np.float32),
        'conv_w': rng.randn(6, 4, 3, 3).astype(np.float32) * 0.3,
        'dw_w': rng.randn(4, 1, 3, 3).astype(np.float32) * 0.3,
        'bn_s': rng.rand(4).astype(np.float32) + 0.5,
        'bn_b': rng.randn(4).astype(np.float32),
        'bn_m': rng.randn(4).astype(np.float32) * 0.1,
        'bn_v': rng.rand(4).astype(np.float32) + 0.5,
        'ln_s': rng.randn(4 * 8 * 8).astype(np.float32),
        'ln_b': rng.randn(4 * 8 * 8).astype(np.float32),
        'alpha': rng.rand(4).astype(np.float32),
        'mat': rng.randn(8, 5).astype(np.float32),
        'fc_w': rng.randn(4 * 8 * 8, 7).astype(np.float32) * 0.1,
        'fc_b': rng.randn(7).astype(np.float32),
        'table': rng.randn(10, 3).astype(np.float32),
    }
    variables, ops, fetches = [], [], []
    for name, arr in params.items():
        variables.append(_var(name, dims=list(arr.shape), persistable=True))
    for i, (op, attrs) in enumerate(_UNARY):
        ops.append(_unary(op, 'x', 'u%d' % i, attrs))
        fetches.append('u%d' % i)
    for i, (op, attrs) in enumerate(_BINARY):
        y = 'y_ch' if attrs else 'y_full'
        ops.append(_binary(op, 'x', y, 'b%d' % i, attrs))
        fetches.append('b%d' % i)
    ops += [
        _op('conv2d', [('Input', ['x']), ('Filter', ['conv_w'])],
            [('Output', ['conv'])],
            [('strides', 3, [2, 2]), ('padding_algorithm', 2, 'SAME'),
             ('dilations', 3, [1, 1]), ('groups', 0, 1)]),
        _op('depthwise_conv2d', [('Input', ['x']), ('Filter', ['dw_w'])],
            [('Output', ['dw'])],
            [('strides', 3, [1, 1]), ('paddings', 3, [1, 0, 2, 1]),
             ('dilations', 3, [2, 1]), ('groups', 0, 4)]),
        _op('batch_norm', [('X', ['x']), ('Scale', ['bn_s']),
                           ('Bias', ['bn_b']), ('Mean', ['bn_m']),
                           ('Variance', ['bn_v'])], [('Y', ['bn'])],
            [('epsilon', 1, 1e-5)]),
        _op('layer_norm', [('X', ['x']), ('Scale', ['ln_s']),
                           ('Bias', ['ln_b'])], [('Y', ['ln'])],
            [('begin_norm_axis', 0, 1), ('epsilon', 1, 1e-5)]),
        _op('instance_norm', [('X', ['x']), ('Scale', ['bn_s']),
                              ('Bias', ['bn_b'])], [('Y', ['inorm'])]),
        _op('prelu', [('X', ['x']), ('Alpha', ['alpha'])],
            [('Out', ['prelu'])], [('mode', 2, 'channel')]),
        _op('mul', [('X', ['x']), ('Y', ['mat'])], [('Out', ['mul'])],
            [('x_num_col_dims', 0, 3), ('y_num_col_dims', 0, 1)]),
        _op('matmul', [('X', ['x']), ('Y', ['x'])], [('Out', ['mm'])],
            [('transpose_Y', 6, True), ('alpha', 1, 0.5)]),
        _op('matmul_v2', [('X', ['x']), ('Y', ['mat'])], [('Out', ['mm2'])],
            [('trans_x', 6, False)]),
        _op('fc', [('Input', ['x']), ('W', ['fc_w']), ('Bias', ['fc_b'])],
            [('Out', ['fc'])], [('in_num_col_dims', 0, 1),
                                ('activation_type', 2, 'relu')]),
        _op('split', [('X', ['x'])], [('Out', ['s0', 's1'])],
            [('axis', 0, 1), ('sections', 3, [1, -1])]),
        _op('concat', [('X', ['s1', 's0'])], [('Out', ['cat'])],
            [('axis', 0, 1)]),
        _op('stack', [('X', ['s0', 's0'])], [('Y', ['stk'])],
            [('axis', 0, 0)]),
        _op('slice', [('Input', ['x'])], [('Out', ['sl'])],
            [('axes', 3, [1, 3]), ('starts', 3, [1, -5]),
             ('ends', 3, [3, 100]), ('decrease_axis', 3, [])]),
        _op('shape', [('Input', ['x'])], [('Out', ['shp'])]),
        _op('fill_constant', [], [('Out', ['full'])],
            [('shape', 3, [2, 3]), ('value', 1, 2.5), ('dtype', 0, 5)]),
        _op('one_hot_v2', [('X', ['ids'])], [('Out', ['oh'])],
            [('depth', 0, 10)]),
        _op('lookup_table', [('Ids', ['ids1']), ('W', ['table'])],
            [('Out', ['lut'])]),
        _op('unsqueeze2', [('X', ['ids'])], [('Out', ['ids1'])],
            [('axes', 3, [2])]),
    ]
    # lookup_table reads ids1, which unsqueeze2 makes: move it first
    ops.insert(len(ops) - 2, ops.pop())
    fetches += ['conv', 'dw', 'bn', 'ln', 'inorm', 'prelu', 'mul', 'mm',
                'mm2', 'fc', 's0', 's1', 'cat', 'stk', 'sl', 'shp', 'full',
                'oh', 'lut']
    head_vars, head_ops, tail = _feed_fetch(['x', 'ids'], fetches)
    variables = head_vars + [_var('x', dims=[-1, 4, 8, 8]),
                             _var('ids', dims=[-1, 3], dtype=3)] + variables
    return _write_model(tmp_path, 'table', variables,
                        head_ops + ops + tail, params), fetches


def _neg_shape_dir(tmp_path):
    variables, head, tail = _feed_fetch(['x'], ['row'])
    variables += [_var('x', dims=[-1, 2, 6]), _var('r', dims=[-1, 6]),
                  _var('row', dims=[6])]
    ops = [
        _op('reshape2', [('X', ['x'])], [('Out', ['r'])],
            [('shape', 3, [-1, 6])]),
        _op('slice', [('Input', ['r'])], [('Out', ['row'])],
            [('axes', 3, [0]), ('starts', 3, [0]), ('ends', 3, [1]),
             ('decrease_axis', 3, [0])]),
    ]
    return _write_model(tmp_path, 'negshape', variables, head + ops + tail)


def _yolo_dir(tmp_path):
    variables, head, tail = _feed_fetch(['head', 'imgsz'], ['boxes'])
    variables += [_var('head', dims=[-1, 27, 4, 4]),
                  _var('imgsz', dims=[-1, 2], dtype=2),
                  _var('boxes', dims=[-1, 48, 4]),
                  _var('scores', dims=[-1, 48, 4])]
    ops = [_op('yolo_box', [('X', ['head']), ('ImgSize', ['imgsz'])],
               [('Boxes', ['boxes']), ('Scores', ['scores'])],
               [('anchors', 3, [10, 13, 16, 30, 33, 23]),
                ('class_num', 0, 4)])]
    return _write_model(tmp_path, 'yolo', variables, head + ops + tail)


def _cpu_config(path, params=None):
    config = tinf.Config(path, params)
    config.disable_gpu()
    return config


def _both_loaders(path, feed, params_path=None):
    """The outputs of each package's load_fluid_model(...).run on feed."""
    jout = jfp.load_fluid_model(path, params_path).run(feed)
    tout = tfp.load_fluid_model(path, params_path, device='cpu').run(feed)
    assert len(jout) == len(tout)
    return [np.asarray(a) for a in jout], tout


def _both_predictors(path, arrays, params_path=None):
    jcfg = jinf.Config(path)
    if params_path:
        jcfg.set_model(path, params_path)
    jpred = jinf.create_predictor(jcfg)
    tpred = tinf.create_predictor(_cpu_config(path, params_path))
    assert tpred.get_input_names() == jpred.get_input_names()
    return jpred.run(list(arrays)), tpred.run(list(arrays)), tpred


# -- tests --------------------------------------------------------------------

@pytest.mark.parametrize('combined', [False, True])
def test_fit_a_line_both_layouts_match_jax(tmp_path, combined):
    d, w, b = _fit_a_line_dir(tmp_path, combined)
    x = np.random.RandomState(2).randn(5, 13).astype(np.float32)
    model, params = (str(d / '__model__'), str(d / '__params__')) \
        if combined else (str(d), None)
    (jout,), (tout,) = _both_loaders(model, {'x': x}, params)
    np.testing.assert_allclose(tout, jout, **TOL)
    np.testing.assert_allclose(tout, x @ w + b, rtol=1e-5, atol=1e-5)
    (jp,), (tp,), pred = _both_predictors(model, [x], params)
    np.testing.assert_allclose(tp, jp, **TOL)
    np.testing.assert_allclose(tp, tout, **TOL)
    assert pred.compile_count() == 1
    # a second run of the signature compiles nothing
    pred.run([x])
    assert pred.compile_count() == 1


def test_digits_cnn_matches_jax(tmp_path):
    d, _ = _digits_cnn_dir(tmp_path)
    x = np.random.RandomState(3).rand(2, 1, 28, 28).astype(np.float32)
    (jout,), (tout,) = _both_loaders(str(d), {'img': x})
    np.testing.assert_allclose(tout, jout, **TOL)
    (jp,), (tp,), _ = _both_predictors(str(d), [x])
    np.testing.assert_allclose(tp, jp, **TOL)


def test_word2vec_matches_jax(tmp_path):
    d = _word2vec_dir(tmp_path)
    rng = np.random.RandomState(8)
    ids = [rng.randint(0, 50, (6,)).astype(np.int64) for _ in range(4)]
    feed = {'w%d' % i: a for i, a in enumerate(ids)}
    (jout,), (tout,) = _both_loaders(str(d), feed)
    np.testing.assert_allclose(tout, jout, **TOL)
    (jp,), (tp,), pred = _both_predictors(str(d), ids)
    assert pred.get_input_names() == ['w0', 'w1', 'w2', 'w3']
    np.testing.assert_allclose(tp, jp, **TOL)


def test_extended_op_table_matches_jax(tmp_path):
    d, fetches = _table_dir(tmp_path)
    rng = np.random.RandomState(12)
    x = rng.randn(2, 4, 8, 8).astype(np.float32)
    ids = rng.randint(0, 10, (2, 3)).astype(np.int64)
    jout, tout = _both_loaders(str(d), {'x': x, 'ids': ids})
    for name, j, t in zip(fetches, jout, tout):
        assert t.shape == j.shape, (name, t.shape, j.shape)
        np.testing.assert_allclose(t.astype(np.float64),
                                   j.astype(np.float64), err_msg=name, **TOL)


def test_extended_op_table_matches_jax_through_predictors(tmp_path):
    d = _table_dir(tmp_path)[0]
    rng = np.random.RandomState(13)
    arrays = [rng.randn(2, 4, 8, 8).astype(np.float32),
              rng.randint(0, 10, (2, 3)).astype(np.int64)]
    jouts, touts, _ = _both_predictors(str(d), arrays)
    for j, t in zip(jouts, touts):
        np.testing.assert_allclose(np.asarray(t, np.float64),
                                   np.asarray(j, np.float64), **TOL)


def test_reshape_neg1_and_decrease_axis_match_jax(tmp_path):
    d = _neg_shape_dir(tmp_path)
    x = np.random.RandomState(5).randn(2, 2, 6).astype(np.float32)
    (jout,), (tout,) = _both_loaders(str(d), {'x': x})
    assert tout.shape == jout.shape == (6,)
    np.testing.assert_allclose(tout, jout, **TOL)
    np.testing.assert_allclose(tout, x.reshape(-1, 6)[0], rtol=1e-6)


def test_parser_roundtrips_negative_and_typed_attrs_as_jax():
    blk = _block([_var('v', dims=[-1, 7]),
                  _var('p', dims=[3], persistable=True, dtype=22)],
                 [_op('scale', [('X', ['v'])], [('Out', ['v2'])],
                      [('scale', 1, 2.5), ('bias', 1, -1.0),
                       ('bias_after_scale', 6, True)]),
                  _op('reshape2', [('X', ['v2'])], [('Out', ['v3'])],
                      [('shape', 3, [-1, 7])]),
                  _op('slice', [('Input', ['v3'])], [('Out', ['v4'])],
                      [('axes', 3, [0]), ('starts', 3, [-2]),
                       ('ends', 3, [-1]), ('decrease_axis', 3, [0])]),
                  _op('mixed', [], [],
                      [('i', 0, -3), ('s', 2, 'abc'), ('fs', 4, [0.5, -2.0]),
                       ('ls', 11, [-(1 << 40), 7]), ('b', 6, False)])])
    data = _program([blk])
    want = jfp.parse_program_desc(data)
    got = tfp.parse_program_desc(data)
    assert len(got) == len(want) == 1
    for g, w in zip(got[0].ops, want[0].ops):
        assert (g.type, g.inputs, g.outputs) == (w.type, w.inputs, w.outputs)
        assert g.attrs == pytest.approx(w.attrs)
    assert got[0].ops[1].attr('shape') == [-1, 7]
    assert got[0].ops[2].attr('starts') == [-2]
    assert got[0].ops[3].attr('ls') == [-(1 << 40), 7]
    for name in ('v', 'p'):
        g, w = got[0].vars[name], want[0].vars[name]
        assert (g.shape, g.dtype, g.persistable) == \
            (w.shape, w.dtype, w.persistable)


def test_trailing_byte_guard_as_jax(tmp_path):
    d, w, _ = _fit_a_line_dir(tmp_path, combined=True)
    model, params = str(d / '__model__'), str(d / '__params__')
    prog = tfp.load_fluid_model(model, params, device='cpu')
    assert prog.feed_names == ['x'] and len(prog.params) == 2
    np.testing.assert_array_equal(prog.params['fc_w'].numpy(), w)
    with open(params, 'ab') as f:
        f.write(b'\x00')
    for loader in (jfp.load_fluid_model,
                   lambda m, p: tfp.load_fluid_model(m, p, device='cpu')):
        with pytest.raises(ValueError, match='trailing'):
            loader(model, params)


def test_bf16_lod_tensor_reads_without_ml_dtypes(tmp_path, monkeypatch):
    vals = np.random.RandomState(4).randn(3, 5).astype(np.float32)
    bits = torch.from_numpy(vals).to(torch.bfloat16).view(torch.int16) \
        .numpy().view(np.uint16)
    path = tmp_path / 'bf16'
    with open(path, 'wb') as f:
        _write_lod_tensor(f, bits, dtype=22)
    with open(path, 'rb') as f:
        want = jfp.read_lod_tensor(f)
    real_import = builtins.__import__

    def no_ml_dtypes(name, *args, **kwargs):
        if name.split('.')[0] == 'ml_dtypes':
            raise ImportError('no ml_dtypes')
        return real_import(name, *args, **kwargs)
    monkeypatch.setattr(builtins, '__import__', no_ml_dtypes)
    with open(path, 'rb') as f:
        got = tfp.read_lod_tensor(f)
    monkeypatch.undo()
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (3, 5)
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))


def test_executor_load_inference_model_serves_reference_dir_as_jax(tmp_path):
    import paddle_tpu as paddle
    d, w, b = _fit_a_line_dir(tmp_path, combined=False)
    x = np.random.RandomState(4).randn(3, 13).astype(np.float32)
    jexe = paddle.static.Executor()
    jprog, jfeeds, jfetches = paddle.static.load_inference_model(str(d), jexe)
    exe = tstatic.Executor('cpu')
    prog, feeds, fetches = tstatic.load_inference_model(str(d), exe)
    assert feeds == jfeeds == ['x'] and fetches == jfetches
    jout, = jexe.run(jprog, feed={'x': x}, fetch_list=jfetches)
    out, = exe.run(prog, feed={'x': x}, fetch_list=fetches)
    np.testing.assert_allclose(out, jout, **TOL)
    tensor, = exe.run(prog, feed={'x': x}, fetch_list=fetches,
                      return_numpy=False)
    assert isinstance(tensor, torch.Tensor) and prog.compile_count() == 1


def _anchors_dir(tmp_path):
    """prior_box and anchor_generator over a feature map, the priors
    flattened by reshape2, and box_coder encoding ground truths against
    them."""
    variables, head, tail = _feed_fetch(
        ['feat', 'img', 'gt'], ['pb', 'pv', 'an', 'av', 'enc'])
    variables += [_var('feat', dims=[-1, 8, 3, 4]),
                  _var('img', dims=[-1, 3, 48, 64]), _var('gt', dims=[-1, 4]),
                  _var('pb', dims=[3, 4, 6, 4]), _var('pv', dims=[3, 4, 6, 4]),
                  _var('pb2', dims=[-1, 4]), _var('an', dims=[3, 4, 4, 4]),
                  _var('av', dims=[3, 4, 4, 4]), _var('enc', dims=[-1, 72, 4])]
    ops = [
        _op('prior_box', [('Input', ['feat']), ('Image', ['img'])],
            [('Boxes', ['pb']), ('Variances', ['pv'])],
            [('min_sizes', 4, [16.0, 24.0]), ('max_sizes', 4, [32.0, 40.0]),
             ('aspect_ratios', 4, [2.0]), ('flip', 6, True),
             ('clip', 6, True), ('variances', 4, [0.1, 0.1, 0.2, 0.2]),
             ('offset', 1, 0.5)]),
        _op('anchor_generator', [('Input', ['feat'])],
            [('Anchors', ['an']), ('Variances', ['av'])],
            [('anchor_sizes', 4, [32.0, 64.0]),
             ('aspect_ratios', 4, [0.5, 1.0]), ('stride', 4, [16.0, 16.0]),
             ('offset', 1, 0.5)]),
        _op('reshape2', [('X', ['pb'])], [('Out', ['pb2'])],
            [('shape', 3, [-1, 4])]),
        _op('box_coder', [('PriorBox', ['pb2']), ('TargetBox', ['gt'])],
            [('OutputBox', ['enc'])],
            [('code_type', 2, 'encode_center_size'),
             ('box_normalized', 6, True),
             ('variance', 4, [0.1, 0.1, 0.2, 0.2])]),
    ]
    return _write_model(tmp_path, 'anchors', variables, head + ops + tail)


def _refusal_dir(tmp_path, name, op):
    variables, head, tail = _feed_fetch(['a', 'b'], ['out'])
    variables += [_var('a', dims=[-1, 6, 4]), _var('b', dims=[-1, 3, 6]),
                  _var('out', dims=[-1, 6])]
    return _write_model(tmp_path, name, variables, head + [op] + tail)


def test_vision_ops_raise_naming_vision(tmp_path):
    """Since slice 20 the detection ops run (their name is kept from the
    slice that refused them): yolo_box, and prior_box / anchor_generator
    / box_coder in one compiled block, through both packages' loaders;
    the two refusals the JAX table keeps (adaptive NMS, roi_align without
    RoisNum) raise in both with its messages."""
    feed = {'head': np.random.RandomState(5).randn(2, 27, 4, 4).astype(
        np.float32), 'imgsz': np.array([[128, 128], [64, 96]], np.int32)}
    jout, tout = _both_loaders(str(_yolo_dir(tmp_path)), feed)
    np.testing.assert_allclose(tout[0], jout[0], **TOL)
    rng = np.random.RandomState(6)
    gt = rng.rand(5, 4).astype(np.float32) * 0.5
    gt[:, 2:] += gt[:, :2] + 0.1
    feed = {'feat': np.zeros((1, 8, 3, 4), np.float32),
            'img': np.zeros((1, 3, 48, 64), np.float32), 'gt': gt}
    jout, tout = _both_loaders(str(_anchors_dir(tmp_path)), feed)
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t, j, **TOL)
    for name in ('yolo_box', 'multiclass_nms', 'multiclass_nms2',
                 'multiclass_nms3', 'roi_align', 'box_coder', 'prior_box',
                 'anchor_generator'):
        assert name in jfp.FLUID_OP_TABLE and name in tfp.FLUID_OP_TABLE
    nms = _op('multiclass_nms', [('BBoxes', ['a']), ('Scores', ['b'])],
              [('Out', ['out'])], [('nms_eta', 1, 0.5)])
    roi = _op('roi_align', [('X', ['a']), ('ROIs', ['b'])],
              [('Out', ['out'])], [('pooled_height', 0, 2)])
    feeds = {'a': np.zeros((1, 6, 4), np.float32),
             'b': np.zeros((1, 3, 6), np.float32)}
    for name, op, match in (('eta', nms, 'nms_eta != 1'),
                            ('lod', roi, 'RoisNum')):
        d = str(_refusal_dir(tmp_path, name, op))
        with pytest.raises(NotImplementedError, match=match):
            jfp.load_fluid_model(d).run(feeds)
        prog = tfp.load_fluid_model(d, device='cpu')
        with pytest.raises(NotImplementedError, match=match):
            prog._run_block(prog.params, {k: torch.from_numpy(v)
                                          for k, v in feeds.items()})


def test_unknown_op_raises_listing_the_table(tmp_path):
    variables, head, tail = _feed_fetch(['x'], ['y'])
    variables += [_var('x', dims=[-1, 2]), _var('y', dims=[-1, 2])]
    d = _write_model(tmp_path, 'unknown', variables,
                     head + [_unary('no_such_op', 'x', 'y')] + tail)
    prog = tfp.load_fluid_model(str(d), device='cpu')
    with pytest.raises(NotImplementedError, match='no_such_op.*mul'):
        prog._run_block(prog.params, {'x': torch.zeros(1, 2)})
    assert set(tfp.FLUID_OP_TABLE) == set(jfp.FLUID_OP_TABLE)


def test_config_params_file_and_optim_cache_dir(tmp_path, monkeypatch):
    d, w, b = _fit_a_line_dir(tmp_path, combined=True)
    monkeypatch.delenv('TORCHINDUCTOR_CACHE_DIR', raising=False)
    config = _cpu_config(str(d / '__model__'), str(d / '__params__'))
    config.set_optim_cache_dir(str(tmp_path / 'cache'))
    pred = tinf.create_predictor(config)
    assert os.environ['TORCHINDUCTOR_CACHE_DIR'] == str(tmp_path / 'cache')
    x = np.random.RandomState(1).randn(2, 13).astype(np.float32)
    name = pred.get_input_names()[0]
    pred.get_input_handle(name).copy_from_cpu(x)
    pred.run()
    out = pred.get_output_handle('output_0').copy_to_cpu()
    np.testing.assert_allclose(out, x @ w + b, rtol=1e-5, atol=1e-5)
    with pytest.raises(TypeError, match='causal-LM'):
        pred.decode_engine()
