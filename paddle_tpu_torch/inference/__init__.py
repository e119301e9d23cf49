"""Inference engine (counterpart of paddle_tpu/inference/; reference:
paddle/fluid/inference/ AnalysisPredictor, AnalysisConfig, ZeroCopyTensor).

load (a jit.save artifact) -> one compiled program per input signature
(torch.compile, the hand-written kernels inside it) -> cached runs. The
pass-pipeline surface (Config.switch_ir_optim, enable_tensorrt_engine,
...) is kept. Reference-format programs (`__model__` / ProgramDesc
`.pdmodel`) load through inference/fluid_program.py.
"""
from .predictor import (Config, AnalysisConfig, Predictor,  # noqa: F401
                        AnalysisPredictor, create_predictor,
                        create_paddle_predictor, PrecisionType, PlaceType,
                        Tensor, Tensor as PaddleInferTensor, get_version)


class DataType:
    """reference paddle_infer::DataType enum."""
    FLOAT32 = 'float32'
    INT64 = 'int64'
    INT32 = 'int32'
    UINT8 = 'uint8'
    INT8 = 'int8'
    FLOAT16 = 'float16'


_DTYPE_BYTES = {DataType.FLOAT32: 4, DataType.INT64: 8, DataType.INT32: 4,
                DataType.UINT8: 1, DataType.INT8: 1, DataType.FLOAT16: 2}


def get_num_bytes_of_data_type(dtype):
    return _DTYPE_BYTES[dtype]


_PARAMS_SUFFIX = '.pdiparams'


class PredictorPool:
    """reference paddle_infer::services::PredictorPool: `size` predictors
    over one config; each retrieve(i) hands an independent Predictor (its
    own IO buffers and compiled programs).

    Registry-backed construction: `PredictorPool(registry=reg,
    model='m', version='v2')` resolves the artifact through a
    serving.registry.ModelRegistry; version=None follows the serving
    pointer, so a rollout changes what the next pool loads. A jit.save
    artifact is registered by its `.pdiparams` file (an io_save file with
    a CRC manifest, so registration verifies it); the pool loads the
    artifact's prefix. The entry's fingerprint is kept on
    `self.fingerprint`."""

    def __init__(self, config=None, size=1, registry=None, model=None,
                 version=None):
        if size < 1:
            raise ValueError('pool size must be >= 1')
        self.fingerprint = None
        if registry is not None:
            if model is None:
                raise ValueError('registry-backed pool needs model=')
            entry = registry.resolve(model, version)
            self.fingerprint = entry.fingerprint
            path = entry.path
            if path.endswith(_PARAMS_SUFFIX):
                path = path[:-len(_PARAMS_SUFFIX)]
            if config is None:
                config = Config(model_path=path)
            else:
                config.set_model(path, config.params_file())
        if config is None:
            raise ValueError('need a Config or registry= + model=')
        self._preds = [create_predictor(config) for _ in range(size)]

    def retrive(self, idx):  # (sic) the reference binding's spelling
        if not 0 <= idx < len(self._preds):
            raise IndexError('predictor index %d out of range [0, %d)'
                             % (idx, len(self._preds)))
        return self._preds[idx]

    retrieve = retrive
    Retrieve = retrive


__all__ = ['Config', 'AnalysisConfig', 'Predictor', 'AnalysisPredictor',
           'create_predictor', 'create_paddle_predictor', 'PrecisionType',
           'PlaceType', 'DataType', 'Tensor', 'get_version',
           'get_num_bytes_of_data_type', 'PredictorPool']
