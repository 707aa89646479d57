"""Distributed pieces the single-card port needs — counterpart of
``paddle_tpu/distributed`` (only the MoE routing math so far)."""
