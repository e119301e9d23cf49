"""AnalysisPredictor-parity inference engine over torch.compile
(counterpart of paddle_tpu/inference/predictor.py).

create_predictor(Config) loads a jit.save artifact onto the card (or the
CPU with Config.disable_gpu()); the "analysis" is one compiled program per
input signature (jit.StaticFunction: torch.compile with fullgraph, the
flash kernels as custom ops inside it), compiled under the predictor's
lock on the first run of the signature; later runs call the cached
program. Reference-format artifacts (`__model__` / ProgramDesc
`.pdmodel` with LoDTensor params) load through inference/fluid_program.py
and run its op table as one program per signature too.
"""
import inspect
import os
import threading

import numpy as np
import torch

from ..framework import device as device_mod

__all__ = ['Config', 'AnalysisConfig', 'Predictor', 'AnalysisPredictor',
           'create_predictor', 'create_paddle_predictor', 'PrecisionType',
           'PlaceType', 'Tensor', 'get_version']


class PrecisionType:
    Float32 = 0
    Half = 1
    Bfloat16 = 2
    Int8 = 3


class PlaceType:
    CPU = 0
    GPU = 1
    TPU = 4
    XPU = 2


class Config:
    """AnalysisConfig parity. The device is the card ('gpu:0') unless
    disable_gpu(); precision Bfloat16 casts the model. The TensorRT /
    MKLDNN / IR switches are accepted and mean "compile the whole graph"."""

    def __init__(self, model_path=None, params_path=None):
        self._model_path = model_path
        self._params_path = params_path
        self._device = 'gpu'
        self._device_id = 0
        self._precision = PrecisionType.Float32
        self._ir_optim = True
        self._memory_optim = True
        self._cache_dir = None
        self._trt = False
        self._cpu_math_threads = 1

    # -- model paths --------------------------------------------------------
    def set_model(self, model_path, params_path=None):
        self._model_path = model_path
        self._params_path = params_path

    def model_dir(self):
        return self._model_path

    def prog_file(self):
        return self._model_path

    def params_file(self):
        return self._params_path

    # -- device -------------------------------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._device = 'gpu'
        self._device_id = device_id

    def enable_tpu(self, device_id=0):
        raise ValueError(
            'enable_tpu: paddle_tpu_torch runs on CUDA GPUs and the CPU '
            '(enable_use_gpu / disable_gpu); the TPU package is paddle_tpu')

    def disable_gpu(self):
        self._device = 'cpu'

    def use_gpu(self):
        return self._device == 'gpu'

    def gpu_device_id(self):
        return self._device_id

    def device(self):
        """The torch device the predictor runs on (raises on a card
        request without CUDA)."""
        if self._device == 'cpu':
            return device_mod.resolve('cpu')
        return device_mod.resolve('gpu:%d' % self._device_id)

    def set_cpu_math_library_num_threads(self, n):
        self._cpu_math_threads = n

    # -- optimization surface ------------------------------------------------
    def switch_ir_optim(self, flag=True):
        self._ir_optim = flag

    def ir_optim(self):
        return self._ir_optim

    def enable_memory_optim(self, flag=True):
        self._memory_optim = flag

    def switch_use_feed_fetch_ops(self, flag):
        pass

    def switch_specify_input_names(self, flag=True):
        pass

    def enable_tensorrt_engine(self, workspace_size=1 << 30, max_batch_size=1,
                               min_subgraph_size=3,
                               precision_mode=PrecisionType.Float32,
                               use_static=False, use_calib_mode=False):
        # subgraph offload means "compile the whole graph" here; the
        # precision is honoured
        self._trt = True
        self._precision = precision_mode

    def tensorrt_engine_enabled(self):
        return self._trt

    def enable_mkldnn(self):
        pass

    def set_optim_cache_dir(self, path):
        self._cache_dir = path

    def enable_profile(self):
        pass

    def disable_glog_info(self):
        pass

    def summary(self):
        return ('device: %s, precision: %s, ir_optim(torch.compile): %s'
                % (self._device, self._precision, self._ir_optim))


AnalysisConfig = Config


class Tensor:
    """Input / output handle (ZeroCopyTensor parity)."""

    def __init__(self, name, predictor):
        self._name = name
        self._predictor = predictor

    def name(self):
        return self._name

    # input side
    def reshape(self, shape):
        self._predictor._input_shapes[self._name] = tuple(shape)

    def copy_from_cpu(self, data):
        self._predictor._check_input_name(self._name)
        self._predictor._inputs[self._name] = np.ascontiguousarray(data)

    def share_external_data(self, data):
        self._predictor._check_input_name(self._name)
        self._predictor._inputs[self._name] = np.asarray(data)

    # output side
    def copy_to_cpu(self):
        return np.asarray(self._predictor._outputs[self._name])

    def to_numpy(self):
        return self.copy_to_cpu()

    def shape(self):
        if self._name in self._predictor._outputs:
            return list(self._predictor._outputs[self._name].shape)
        return list(self._predictor._input_shapes.get(self._name, ()))

    def type(self):
        return PrecisionType.Float32


def _to_numpy(t):
    """A result on the host; bf16 (which numpy lacks) as its f32 values."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


class Predictor:
    """AnalysisPredictor parity over a jit.save'd model."""

    def __init__(self, config):
        self._config = config
        self._inputs = {}
        self._outputs = {}
        self._input_shapes = {}
        self._lock = threading.Lock()
        self._ran = set()
        self._load()

    @staticmethod
    def _is_fluid_artifact(path):
        """A reference-produced artifact? (__model__ / *.pdmodel
        ProgramDesc, analysis_predictor.cc PrepareProgram's input)."""
        if os.path.isdir(path):
            if os.path.exists(os.path.join(path, '__model__')):
                return True
            return any(f.endswith('.pdmodel') for f in os.listdir(path))
        return (path.endswith('.pdmodel')
                or os.path.basename(path) == '__model__')

    def _load_fluid(self, path):
        """Serve a reference-format model: ProgramDesc block 0 through the
        fluid op table (fluid_program.py), compiled once per signature."""
        from .fluid_program import load_fluid_model
        prog = load_fluid_model(path, self._config.params_file(),
                                device=self._device)
        self._fluid = prog
        self._layer = None
        self._translated = None
        self._input_names = list(prog.feed_names)
        self._float_dtype = next(
            (t.dtype for t in prog.params.values() if t.is_floating_point()),
            torch.float32)
        self._program = prog.compiled()

    def _enable_optim_cache(self):
        """Config.set_optim_cache_dir points Inductor's cache (its compiled
        graphs and kernels) at the directory, through
        framework.compile_cache, so a restarted server reuses them."""
        if self._config._cache_dir:
            from ..framework import compile_cache
            compile_cache.configure_inductor(self._config._cache_dir)

    def _load(self):
        from .. import jit as jit_mod
        path = self._config.model_dir()
        if path is None:
            raise ValueError('Config.set_model(path) required')
        self._enable_optim_cache()
        self._device = self._config.device()
        if self._is_fluid_artifact(path):
            self._load_fluid(path)
            return
        self._translated = jit_mod.load(path, device=self._device)
        layer = self._translated._layer
        if layer is None:
            raise RuntimeError('model artifact missing architecture payload')
        layer.eval()
        if self._config._precision == PrecisionType.Bfloat16:
            layer.to(torch.bfloat16)
        self._layer = layer
        self._float_dtype = next(
            (p.dtype for p in layer.parameters() if p.is_floating_point()),
            torch.float32)
        # input names from the saved input spec when available; otherwise
        # the forward's required positional parameters (a variadic forward
        # takes any number of input_<i>)
        meta = self._translated._meta
        spec = meta.get('input_spec')
        if spec:
            self._input_names = [
                (s[2] if len(s) > 2 and s[2] else 'input_%d' % i)
                for i, s in enumerate(spec)]
        else:
            self._input_names = None
            try:
                ps = list(inspect.signature(layer.forward).parameters
                          .values())
                if not any(p.kind == p.VAR_POSITIONAL for p in ps):
                    req = [p for p in ps
                           if p.kind in (p.POSITIONAL_ONLY,
                                         p.POSITIONAL_OR_KEYWORD)
                           and p.default is p.empty]
                    self._input_names = ['input_%d' % i
                                         for i in range(len(req))]
            except (TypeError, ValueError):
                pass
        self._program = jit_mod.StaticFunction(layer.forward, layer=layer)

    def _check_input_name(self, name):
        if self._input_names is not None:
            if name not in self._input_names:
                raise ValueError(
                    'unknown input %r; model inputs are %s'
                    % (name, self._input_names))
        elif not (name.startswith('input_')
                  and name[len('input_'):].isdigit()):
            raise ValueError(
                'model was saved without an input spec; use positional '
                'names input_0..input_<n-1>, got %r' % name)

    def _gather_inputs(self):
        """The run's arguments in declared order; a missing input raises."""
        if self._input_names is not None:
            missing = [n for n in self._input_names if n not in self._inputs]
            if missing:
                raise ValueError('inputs not set: %s' % missing)
            return [self._inputs[n] for n in self._input_names]
        idx = sorted(int(n[len('input_'):]) for n in self._inputs)
        if idx != list(range(len(idx))):
            raise ValueError(
                'positional inputs must be contiguous input_0..input_%d, '
                'got %s' % (len(idx) - 1, sorted(self._inputs)))
        return [self._inputs['input_%d' % i] for i in idx]

    def _to_device(self, a):
        t = torch.from_numpy(np.asarray(a)).to(self._device)
        if t.is_floating_point():
            t = t.to(self._float_dtype)
        return t

    # -- handles -------------------------------------------------------------
    def get_input_names(self):
        if self._input_names is not None:
            return list(self._input_names)
        return sorted(self._inputs, key=lambda n: int(n[len('input_'):]))

    def get_input_handle(self, name):
        return Tensor(name, self)

    def get_input_tensor(self, name):
        return Tensor(name, self)

    def get_output_names(self):
        return list(self._outputs.keys()) or ['output_0']

    def get_output_handle(self, name):
        return Tensor(name, self)

    def get_output_tensor(self, name):
        return Tensor(name, self)

    # -- run ------------------------------------------------------------------
    def compile_count(self):
        """Programs compiled so far (one per input signature)."""
        return self._program.compile_count()

    def run(self, input_list=None):
        """ZeroCopyRun: the first run of a signature compiles under the
        lock, later runs call its program. run([arrays]) returns arrays."""
        arrays = list(input_list) if input_list is not None \
            else self._gather_inputs()
        tensors = [self._to_device(a) for a in arrays]
        sig = tuple((tuple(t.shape), t.dtype) for t in tensors)
        with torch.no_grad():
            if sig in self._ran:
                out = self._program(*tensors)
            else:
                with self._lock:
                    out = self._program(*tensors)
                    self._ran.add(sig)
        outs = out if isinstance(out, (list, tuple)) else [out]
        self._outputs = {'output_%d' % i: _to_numpy(o)
                         for i, o in enumerate(outs)}
        if input_list is not None:
            return [self._outputs['output_%d' % i] for i in range(len(outs))]
        return True

    def clone(self):
        return Predictor(self._config)

    def decode_engine(self, num_slots=8, max_len=None, prefill_chunk=16,
                      decode_block=4, paged=False, **paged_kwargs):
        """Continuous-batching front door over the loaded model: a causal
        LM with the slot-cache decode path (GPTForCausalLM), else
        TypeError. `paged=True` returns the page-granular engine; its
        keyword arguments (page_size, num_pages, spec_k, prefix_cache, ...)
        pass through."""
        layer = self._layer
        if layer is None or not (hasattr(layer, 'generate')
                                 and hasattr(layer, 'gpt')
                                 and hasattr(layer, 'config')):
            raise TypeError(
                'decode_engine() needs a causal-LM artifact '
                '(GPTForCausalLM with a KV-cache decode path); loaded '
                'model is %s' % type(layer).__name__)
        if paged:
            from ..serving import PagedContinuousBatchingEngine
            return PagedContinuousBatchingEngine(
                layer, num_seqs=num_slots, max_len=max_len,
                prefill_chunk=prefill_chunk, decode_block=decode_block,
                **paged_kwargs)
        if paged_kwargs:
            raise TypeError('decode_engine() got paged-only arguments %r '
                            'without paged=True' % sorted(paged_kwargs))
        from ..serving import ContinuousBatchingEngine
        return ContinuousBatchingEngine(
            layer, num_slots=num_slots, max_len=max_len,
            prefill_chunk=prefill_chunk, decode_block=decode_block)

    def decode_gateway(self, replicas=2, router=None, autoscaler=None,
                       registry=None, **engine_kwargs):
        """A ServingGateway whose replicas are decode engines over this
        predictor's model (decode_engine's keyword arguments pass
        through)."""
        from ..serving import ServingGateway
        return ServingGateway(
            lambda: self.decode_engine(**engine_kwargs),
            replicas=replicas, router=router, autoscaler=autoscaler,
            registry=registry)

    def clear_intermediate_tensor(self):
        self._outputs = {}

    def try_shrink_memory(self):
        if self._device.type == 'cuda':
            torch.cuda.empty_cache()


AnalysisPredictor = Predictor


def create_predictor(config):
    return Predictor(config)


def create_paddle_predictor(config):
    return Predictor(config)


def get_version():
    from .. import __version__
    return __version__
