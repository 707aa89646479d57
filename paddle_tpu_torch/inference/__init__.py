"""``paddle.inference`` — counterpart of ``paddle_tpu/inference``: the
deployment predictor API beside the LLM serving tiers.

Parity target: ``paddle/fluid/inference/api/analysis_predictor.cc`` and
the ``paddle_infer`` Python surface in the reference (Config,
create_predictor, Predictor with named input/output handles). The
artifact is what ``paddle.jit.save`` writes — a ``torch.export`` program
whose kernel calls are the port's ``torch.library`` ops
(``kernels/ops.py``) — loaded through ``jit.load``: on the card its
flash attention and int8 matmul run the hand-written kernels. Config's
GPU knobs choose the device; the TensorRT / MKLDNN / IR-pass knobs are
recorded, queryable and warn once, having no counterpart here.

LLM serving tiers: :class:`GenerationPredictor` (``inference.generation``)
and the continuous-batching engine (``inference.serving``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .generation import GenerationConfig, GenerationPredictor

__all__ = ["Config", "Predictor", "Tensor", "create_predictor",
           "PrecisionType", "PlaceType", "get_version", "GenerationConfig",
           "GenerationPredictor"]


def get_version() -> str:
    from .. import __version__
    return f"paddle_tpu_torch inference {__version__}"


class PrecisionType:
    Float32 = 0
    Half = 1
    Bfloat16 = 2
    Int8 = 3


class PlaceType:
    CPU = 0
    GPU = 1
    XPU = 2
    CUSTOM = 3


def _noop_warn(knob: str, equivalent: str):
    """One-time warning per knob: a ported workload must not silently
    believe it enabled an optimizer that does nothing here."""
    import warnings
    if knob not in _noop_warn._seen:
        _noop_warn._seen.add(knob)
        warnings.warn(f"inference.Config.{knob} has no effect in "
                      f"paddle_tpu_torch — {equivalent}", stacklevel=3)


_noop_warn._seen = set()


class Config:
    """ref: paddle_infer.Config — model path pair + device/opt toggles."""

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        if prog_file is not None and prog_file.endswith(".pdmodel"):
            prog_file = prog_file[: -len(".pdmodel")]
        self._path_prefix = prog_file
        self._params_file = params_file
        self._records: Dict[str, object] = {}

    # -- the knobs the reference exposes -------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb: int = 100,
                       device_id: int = 0):
        self._records["use_gpu"] = True
        self._records["gpu_device_id"] = int(device_id)

    def disable_gpu(self):
        self._records["use_gpu"] = False

    def use_gpu(self) -> bool:
        return bool(self._records.get("use_gpu", False))

    def gpu_device_id(self) -> int:
        return int(self._records.get("gpu_device_id", 0))

    def enable_tensorrt_engine(self, *a, **k):
        self._records["tensorrt"] = False
        _noop_warn("enable_tensorrt_engine",
                   "the saved program runs the port's hand-written kernels "
                   "as exported; there is no TensorRT subgraph pass")

    def enable_mkldnn(self):
        self._records["mkldnn"] = False
        _noop_warn("enable_mkldnn", "CPU execution is PyTorch's; no oneDNN "
                   "switch")

    def switch_ir_optim(self, flag: bool = True):
        self._records["ir_optim"] = bool(flag)
        _noop_warn("switch_ir_optim",
                   "the exported program is run as saved; no IR passes")

    def enable_memory_optim(self):
        self._records["memory_optim"] = True
        _noop_warn("enable_memory_optim",
                   "PyTorch's caching allocator reuses memory already")

    def set_cpu_math_library_num_threads(self, n: int):
        self._records["cpu_threads"] = int(n)
        _noop_warn("set_cpu_math_library_num_threads",
                   "use torch.set_num_threads")

    def model_dir(self):
        return self._path_prefix

    def prog_file(self):
        return (self._path_prefix or "") + ".pdmodel"

    def params_file(self):
        return self._params_file or (self._path_prefix or "") + ".pdiparams"

    def summary(self) -> str:
        return f"Config(path={self._path_prefix}, records={self._records})"

    def clone(self) -> "Config":
        """ref: Config copy for spawning per-thread predictors."""
        c = Config()
        c._path_prefix = self._path_prefix
        c._params_file = self._params_file
        c._records = dict(self._records)
        return c


class Tensor:
    """Named IO handle (ref: paddle_infer.Tensor zero-copy handles)."""

    def __init__(self, name: str, slot: Dict):
        self._name = name
        self._slot = slot

    def name(self) -> str:
        return self._name

    def copy_from_cpu(self, data: np.ndarray):
        self._slot["value"] = np.ascontiguousarray(data)

    def reshape(self, shape):
        """The input's shape for the next ``copy_from_cpu``: a value of
        the same size is reshaped, another size (a new batch) dropped."""
        v = self._slot.get("value")
        if v is not None and v.size == int(np.prod(shape)):
            self._slot["value"] = v.reshape(shape)
        else:
            self._slot.pop("value", None)
            self._slot["shape"] = list(shape)

    def copy_to_cpu(self) -> np.ndarray:
        return np.asarray(self._slot["value"])

    def shape(self) -> List[int]:
        v = self._slot.get("value")
        return list(v.shape) if v is not None else self._slot.get("shape", [])


class Predictor:
    """ref: paddle_infer.Predictor over the ``jit.save`` artifact."""

    def __init__(self, config: Config):
        from ..jit.api import load as jit_load
        if config._path_prefix is None:
            raise ValueError("Config needs the model path prefix "
                             "(the paddle.jit.save output)")
        use = config._records.get("use_gpu")
        device = None if use is None else (
            f"gpu:{config.gpu_device_id()}" if use else "cpu")
        self._layer = jit_load(config._path_prefix, device=device)
        self._input_specs = getattr(self._layer, "_input_specs", [])
        self._input_names = [s[2] or f"x{i}"
                             for i, s in enumerate(self._input_specs)]
        self._inputs: Dict[str, Dict] = {n: {} for n in self._input_names}
        self._outputs: List[Dict] = []

    def get_input_names(self) -> List[str]:
        return list(self._input_names)

    def get_input_handle(self, name: str) -> Tensor:
        if name not in self._inputs:
            raise KeyError(f"unknown input {name!r}; inputs: "
                           f"{self._input_names}")
        return Tensor(name, self._inputs[name])

    def run(self, inputs: Optional[List[np.ndarray]] = None):
        if inputs is not None:
            for n, v in zip(self._input_names, inputs):
                self._inputs[n]["value"] = np.asarray(v)
        args = []
        for n in self._input_names:
            v = self._inputs[n].get("value")
            if v is None:
                raise RuntimeError(f"input {n!r} not set; use "
                                   f"get_input_handle(...).copy_from_cpu")
            args.append(v)
        outs = self._layer(*args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        self._outputs = [{"value": o.numpy()} for o in outs]
        if inputs is not None:
            return [o["value"] for o in self._outputs]
        return True

    def get_output_names(self) -> List[str]:
        return [f"out{i}" for i in range(len(self._outputs))] or ["out0"]

    def get_output_handle(self, name: str) -> Tensor:
        idx = int(name.replace("out", "") or 0)
        if not self._outputs:
            raise RuntimeError("run() the predictor before reading outputs")
        return Tensor(name, self._outputs[idx])

    def clone(self) -> "Predictor":
        """ref: Predictor.clone — a handle sharing the loaded program and
        weights but with independent IO slots (per-thread serving)."""
        p = object.__new__(Predictor)
        p._layer = self._layer
        p._input_specs = self._input_specs
        p._input_names = list(self._input_names)
        p._inputs = {n: {} for n in p._input_names}
        p._outputs = []
        return p


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)
