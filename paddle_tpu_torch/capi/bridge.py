"""Python side of the C inference API (counterpart of
paddle_tpu/capi/bridge.py; imported by the embedded interpreter inside
libpaddle_tpu_torch_c — see pd_capi.cc).

Keeps the C layer free of numpy/tensor ABI knowledge: tensors cross the
boundary as (raw pointer, shape) on the way in — viewed zero-copy via
ctypes, then copied once into an owned array — and as `bytes` on the way
out (PyBytes_AsStringAndSize is the one stable C-side accessor that needs
no numpy C API). Handles are process-local ints so the C structs stay
POD.

Devices: "gpu" (the first CUDA card; without CUDA, create raises, and
PD_PredictorCreate reports it) and "cpu"; "tpu" raises as
Config.enable_tpu does. The JAX bridge's `_cpu_guard` has no counterpart:
the port selects its device per predictor.

Reference analog: capi_exp's pd_utils.cc marshaling between C structs and
the C++ predictor's tensors.
"""
import ctypes

import numpy as np

_predictors = {}
_next_handle = [1]


def create(model_dir, device):
    from ..inference import Config, create_predictor
    cfg = Config(model_dir)
    if device == 'cpu':
        cfg.disable_gpu()
    elif device == 'tpu':
        cfg.enable_tpu()
    elif device != 'gpu':
        raise ValueError("device %r: the C API serves on 'gpu' or 'cpu'"
                         % device)
    pred = create_predictor(cfg)
    h = _next_handle[0]
    _next_handle[0] += 1
    _predictors[h] = {'pred': pred, 'outputs': []}
    return h


def _get(handle):
    state = _predictors.get(handle)
    if state is None:
        raise ValueError('invalid predictor handle %r' % (handle,))
    return state


def input_num(handle):
    # get_input_names() always returns a list (positional input_N names
    # when the model carries no spec), so a count always exists; -1 on
    # the C side exclusively means error
    return len(_get(handle)['pred'].get_input_names())


def input_name(handle, idx):
    names = _get(handle)['pred'].get_input_names()
    if not names or idx < 0 or idx >= len(names):
        raise IndexError('input index %d out of range (%d inputs)'
                         % (idx, len(names or [])))
    return names[idx]


def set_input_f32(handle, name, ptr, shape):
    pred = _get(handle)['pred']
    count = 1
    for d in shape:
        if d < 0:
            raise ValueError('negative dim in shape %r' % (shape,))
        count *= int(d)
    view = (ctypes.c_float * count).from_address(ptr)
    arr = np.frombuffer(view, dtype=np.float32, count=count).reshape(
        [int(d) for d in shape]).copy()
    pred.get_input_handle(name).copy_from_cpu(arr)
    return 0


def run(handle):
    state = _get(handle)
    pred = state['pred']
    pred.run()
    state['outputs'] = [
        np.ascontiguousarray(
            pred.get_output_handle(n).copy_to_cpu())
        for n in pred.get_output_names()]
    return 0


def output_num(handle):
    return len(_get(handle)['outputs'])


def _output(handle, idx):
    outs = _get(handle)['outputs']
    if idx < 0 or idx >= len(outs):
        raise IndexError('output index %d out of range (%d outputs)'
                         % (idx, len(outs)))
    return outs[idx]


def output_shape(handle, idx):
    return tuple(int(d) for d in _output(handle, idx).shape)


def output_bytes_f32(handle, idx):
    return _output(handle, idx).astype(np.float32, copy=False).tobytes()


def destroy(handle):
    _predictors.pop(handle, None)
    return 0
