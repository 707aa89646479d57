"""``paddle.vision`` — counterpart of ``paddle_tpu/vision`` (transforms,
models, datasets, the detection ops).

Transforms and datasets are host numpy (safe inside DataLoader worker
processes); the models build on the port's layers; ``vision.ops`` holds
the box, NMS and detection-training ops, ``vision.detection`` the
PP-YOLOE detector and ``vision.ocr`` the CRNN recognizer (imported on
use, as in the reference). Downloaders raise: no dataset or weight is
fetched.
"""

from . import datasets, models, ops, transforms  # noqa: F401
from .models import (LeNet, ResNet, resnet18, resnet34, resnet50, resnet101,
                     resnet152, vgg11, vgg13, vgg16, vgg19, VGG)  # noqa: F401

__all__ = ["transforms", "models", "datasets", "ResNet", "LeNet", "VGG",
           "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
           "vgg11", "vgg13", "vgg16", "vgg19", "set_image_backend",
           "get_image_backend", "image_load"]


def set_image_backend(backend: str):
    if backend not in ("cv2", "pil", "numpy", "tensor"):
        raise ValueError(f"unsupported image backend {backend!r}")
    transforms._IMAGE_BACKEND = backend


def get_image_backend() -> str:
    return transforms._IMAGE_BACKEND


def image_load(path: str, backend=None):
    raise NotImplementedError(
        "vision.image_load: this package decodes no image files (no "
        "PIL/cv2 dependency) — load arrays with numpy and feed HWC "
        "ndarrays to the transforms")
