"""Regularizers — counterpart of ``paddle_tpu/regularizer.py`` (Paddle's
L1Decay/L2Decay objects carried on ParamAttr/optimizer and folded into the
gradient by the optimizer)."""

from __future__ import annotations


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __repr__(self):
        return f"L2Decay({self.coeff})"


class L1Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __repr__(self):
        return f"L1Decay({self.coeff})"
