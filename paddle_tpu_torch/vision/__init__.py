"""paddle.vision (counterpart of paddle_tpu/vision/): models, transforms,
datasets, the detection ops (`ops`, `detection`) and PPYOLOv2."""
from . import datasets, detection, models, ops, transforms  # noqa: F401
from .models import *  # noqa: F401,F403


def set_image_backend(backend):
    pass


def get_image_backend():
    return 'numpy'


def image_load(path, backend=None):
    from .datasets import _load_image
    return _load_image(path)
