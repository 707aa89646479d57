"""``paddle.amp`` — counterpart of ``paddle_tpu/amp``: ``auto_cast`` (O1 /
O2 over the white and black op lists, applied by
``core.dispatch.forward_op``), ``GradScaler`` with dynamic loss scaling,
and ``decorate`` for O2 parameters with fp32 master weights. The compute
dtype defaults to bfloat16."""

from .auto_cast import (amp_guard, auto_cast, autocast, decorate,
                        is_bfloat16_supported, is_float16_supported,
                        white_list, black_list, _amp_state)
from .grad_scaler import AmpScaler, GradScaler

__all__ = ["auto_cast", "autocast", "amp_guard", "decorate", "GradScaler",
           "AmpScaler", "is_float16_supported", "is_bfloat16_supported",
           "white_list", "black_list"]
