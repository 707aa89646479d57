"""``paddle.hapi`` — counterpart of ``paddle_tpu/hapi``: the Keras-like
high-level API (ref: ``python/paddle/hapi/model.py``: ``Model.prepare`` /
``fit`` / ``evaluate`` / ``predict`` / ``save`` / ``load``,
``train_batch`` / ``eval_batch``; ``model_summary.py``:
``paddle.summary``). The callbacks are ``paddle_tpu_torch.callbacks``.
"""

from .model import Model
from .model_summary import summary

__all__ = ["Model", "summary"]
