"""Inference tier of the port (counterpart of ``paddle_tpu/inference``)."""
