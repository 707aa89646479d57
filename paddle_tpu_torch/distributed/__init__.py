"""Distributed pieces of the port — counterpart of ``paddle_tpu/distributed``:
the MoE routing math, and the serving tensor-parallel placement and
shard helpers."""
