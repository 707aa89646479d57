"""The port's kernels: hand-written CUDA C++ for Hopper (``csrc/``), each
wrapped beside its plain PyTorch version (counterpart of
``paddle_tpu/kernels``). Importing this package builds nothing; a kernel
is compiled at its first launch (``build.py``)."""
