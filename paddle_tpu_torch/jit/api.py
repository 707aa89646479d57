"""``paddle.jit`` public API: to_static / save / load / InputSpec —
counterpart of ``paddle_tpu/jit/api.py`` (``python/paddle/jit/api.py`` and
``dy2static/program_translator.py``'s ``StaticFunction`` in Paddle).

A program is a captured CUDA graph (``trace.py``). ``jit.save`` writes a
``torch.export`` program of the layer's eval forward, with the parameters
and buffers lifted to inputs, into ``.pdmodel`` and the weights into
``.pdiparams`` (the reference writes StableHLO and a weights pickle);
the kernels an inference forward reaches are ``torch.library`` ops there
(``kernels/ops.py``).
"""

from __future__ import annotations

import functools
import inspect
import io
import os
import pickle
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.dtype import canonical_dtype, get_default_dtype
from ..core.place import torch_device
from ..core.tensor import Tensor, _wrap, raw_value, set_raw_value
from .trace import (HostReadError, StaleProgram, build_program, current_ctx,
                    flatten, on_capture_stream)

__all__ = ["InputSpec", "StaticFunction", "to_static", "not_to_static",
           "ignore_module", "save", "load", "TranslatedLayer",
           "enable_to_static", "fallbacks"]

_to_static_enabled = True

# the calls that ran eagerly where the reference itself runs eagerly: an
# enabled GradScaler (TrainStep), enable_to_static(False), SOT's graph
# break and a to_static call inside another's capture
fallbacks = {"scaler": 0, "to_static_disabled": 0, "sot_graph_break": 0,
             "nested": 0}


def enable_to_static(flag: bool = True):
    """ProgramTranslator().enable() parity — globally bypass compilation."""
    global _to_static_enabled
    _to_static_enabled = bool(flag)


class InputSpec:
    """paddle.static.InputSpec parity. ``None`` dims are symbolic (batch
    etc.)."""

    def __init__(self, shape, dtype="float32", name=None, stop_gradient=True):
        self.shape = list(shape)
        self.dtype = canonical_dtype(dtype) or get_default_dtype()
        self.name = name
        self.stop_gradient = stop_gradient

    @classmethod
    def from_tensor(cls, t: Tensor, name=None):
        return cls(t.shape, t.dtype, name or t.name, t.stop_gradient)

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")

    def _example(self, device=None) -> torch.Tensor:
        """An example value: 2 for a symbolic dim (``torch.export`` would
        specialize a dim whose example size is 0 or 1)."""
        shape = tuple(2 if (d is None or d < 0) else int(d)
                      for d in self.shape)
        return torch.zeros(shape, dtype=self.dtype,
                           device=device or torch_device())

    def _dynamic(self, k: int):
        """``{axis: export.Dim}`` for the symbolic dims of input ``k``."""
        return {i: torch.export.Dim(f"x{k}_d{i}", min=1)
                for i, d in enumerate(self.shape)
                if d is None or d < 0} or None


def _train_flags(layer):
    if layer is None:
        return ()
    return tuple(m.training for m in layer.sublayers(include_self=True))


def _signature(args, kwargs, train_flags=()):
    leaves, spec = flatten((args, kwargs))
    parts = []
    for l in leaves:
        if isinstance(l, Tensor):
            parts.append(("T", tuple(l.shape), str(l.dtype),
                          str(l._value.device)))
        elif isinstance(l, (torch.Tensor, np.ndarray)):
            parts.append(("A", tuple(l.shape), str(l.dtype)))
        else:
            try:
                parts.append(("S", hash(l), type(l).__name__))
            except TypeError:
                parts.append(("S", repr(l)))
    return (spec, tuple(parts), tuple(train_flags))


def _device_of(args, kwargs):
    for l in flatten((args, kwargs))[0]:
        if isinstance(l, Tensor):
            return l._value.device
    return torch_device()


def warmup(fn, args, kwargs):
    """The first call of a function, eagerly: on the card on the capture
    side stream (PyTorch's rule: warm up there, then capture), so the
    kernels, cuBLAS and the allocator are set up for the capture."""
    dev = _device_of(args, kwargs)
    if dev.type != "cuda":
        return fn(*args, **kwargs)
    with on_capture_stream(dev):
        out = fn(*args, **kwargs)
    main = torch.cuda.current_stream(dev)
    for l in flatten(out)[0]:
        if isinstance(l, Tensor) and l._value.device.type == "cuda":
            l._value.record_stream(main)
    return out


class StaticFunction:
    """Signature-cached compiled wrapper (ProgramTranslator StaticFunction
    parity).

    Call 1 per function runs eagerly (lazy state — optimizer
    accumulators, lazily-built sublayers — initializes with real values);
    later calls hit the program cache keyed by (tree structure, shapes,
    dtypes, devices, static values, training flags). A capture that reads
    a tensor on the host retries once through the dy2static rewrite,
    adopted only once it captures."""

    def __init__(self, function, input_spec=None, donate_states=False,
                 layer=None, ast_target=None):
        self._fn = function
        self._input_spec = input_spec
        self._donate = donate_states
        self._layer = layer
        self._programs = {}
        self._warmed_up = False
        self._ast_fn = None
        self._ast_target = ast_target

    @property
    def _train_flags(self):
        return _train_flags(self._layer)

    def _sig(self, args, kwargs):
        return _signature(args, kwargs, self._train_flags)

    def __call__(self, *args, **kwargs):
        if not _to_static_enabled:
            fallbacks["to_static_disabled"] += 1
            return self._fn(*args, **kwargs)
        if current_ctx() is not None:
            fallbacks["nested"] += 1
            return self._fn(*args, **kwargs)
        if not self._warmed_up:
            self._warmed_up = True
            return warmup(self._fn, args, kwargs)
        key = self._sig(args, kwargs)
        prog = self._programs.get(key)
        if prog is not None:
            try:
                return prog(args, kwargs)
            except StaleProgram:
                del self._programs[key]
        prog, out = self._build(args, kwargs)
        self._programs[key] = prog
        return out

    def _build(self, args, kwargs):
        fn = self._ast_fn or self._fn
        try:
            return build_program(fn, args, kwargs,
                                 donate_states=self._donate)
        except HostReadError as e:
            if self._ast_fn is not None:
                raise RuntimeError(
                    "to_static: data-dependent Python control flow remains "
                    "after the dy2static rewrite. Use paddle_tpu_torch.jit."
                    f"cond / while_loop / scan.\noriginal error: {e}") \
                    from None
            from .dy2static import ast_transform
            target = self._ast_target or self._fn
            try:
                if inspect.ismethod(target):
                    tf = ast_transform(target.__func__)
                    cand = functools.partial(tf, target.__self__)
                else:
                    cand = ast_transform(target)
                res = build_program(cand, args, kwargs,
                                    donate_states=self._donate)
            except Exception as e2:
                raise RuntimeError(
                    "to_static: data-dependent Python control flow (if/"
                    "while on a tensor value) cannot be captured, and the "
                    "dy2static AST rewrite could not lower it (branches "
                    "with return/break/continue or object mutation are "
                    "out of its scope). Use paddle_tpu_torch.jit.cond / "
                    "while_loop / scan explicitly, to_static(backend='sot'),"
                    f" or eager mode.\ncapture error: {e}\n"
                    f"dy2static: {e2}") from None
            # adopted only once it captured: a broken transform must not
            # poison later calls
            self._ast_fn = cand
            return res

    @property
    def code(self):
        try:
            return inspect.getsource(self._fn)
        except (OSError, TypeError):
            return "<source unavailable>"

    def concrete_program_specify_input_spec(self, *a, **k):
        return None

    def rollback(self):
        return self._fn


def autograd_under_trace() -> bool:
    """True inside a capture (a nested to_static runs inline)."""
    return current_ctx() is not None


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, donate_states=False, **kwargs):
    """``@paddle.jit.to_static`` parity. Also accepts a Layer instance.

    ``backend="sot"`` selects the path-guarded tier (``jit/sot.py``): one
    program per observed path through data-dependent branches, with the
    graph-break eager fallback. Default (None): capture, with the
    dy2static rewrite as the retry."""

    def decorate(fn):
        from ..nn.layer import Layer

        if backend == "sot":
            from .sot import SOTFunction
            if isinstance(fn, Layer):
                layer = fn
                orig_forward = layer.forward
                sf = SOTFunction(lambda *a, **k: orig_forward(*a, **k),
                                 input_spec, donate_states, layer=layer,
                                 guard_target=orig_forward)
                layer.forward = sf
                layer._static_function = sf
                layer._orig_forward = orig_forward
                return layer
            sf = SOTFunction(fn, input_spec, donate_states)
            functools.update_wrapper(sf, fn)
            return sf
        if backend not in (None, "CINN", "cinn"):
            raise ValueError(f"to_static: unknown backend {backend!r}; "
                             "options: None (capture + AST), 'sot'")
        if isinstance(fn, Layer):
            layer = fn
            orig_forward = layer.forward
            sf = StaticFunction(lambda *a, **k: orig_forward(*a, **k),
                                input_spec, donate_states, layer=layer,
                                ast_target=orig_forward)
            layer.forward = sf
            layer._static_function = sf
            layer._orig_forward = orig_forward
            return layer
        sf = StaticFunction(fn, input_spec, donate_states)
        functools.update_wrapper(sf, fn)
        return sf

    if function is not None:
        return decorate(function)
    return decorate


def not_to_static(fn=None):
    """Marker: never compile this function (paddle.jit.not_to_static
    parity)."""
    if fn is None:
        return lambda f: f
    return fn


def ignore_module(modules):
    return None


# ---------------------------------------------------------------------------
# save / load (a torch.export program + the weights)
# ---------------------------------------------------------------------------

_MODEL_SUFFIX = ".pdmodel"
_PARAMS_SUFFIX = ".pdiparams"


class _Exported(torch.nn.Module):
    """The eval forward as a module of (weights, inputs): what
    ``torch.export`` traces."""

    def __init__(self, fn, tensors, metas):
        super().__init__()
        self._fn, self._tensors, self._metas = fn, tensors, metas

    def forward(self, weights, inputs):
        saved = [raw_value(t) for t in self._tensors]
        for t, v in zip(self._tensors, weights):
            set_raw_value(t, v)
        try:
            args = []
            for v, (sg, name) in zip(inputs, self._metas):
                t = _wrap(v, name=name)
                t._sg = sg
                args.append(t)
            out = self._fn(*args)
        finally:
            for t, v in zip(self._tensors, saved):
                set_raw_value(t, v)
        return [raw_value(l) if isinstance(l, Tensor) else torch.as_tensor(l)
                for l in flatten(out)[0]]


def save(layer, path: str, input_spec: Optional[Sequence] = None, **configs):
    """``paddle.jit.save`` parity: serialize an inference program +
    weights.

    The program is the layer's forward in eval mode with parameters and
    buffers lifted to inputs, exported by ``torch.export`` with a symbolic
    size for every ``None`` dim of ``input_spec``, so it reloads and runs
    without the Python model code and takes any batch."""
    from ..nn.layer import Layer

    if isinstance(layer, StaticFunction):
        fn, model_layer = layer._fn, layer._layer
    elif isinstance(layer, Layer):
        model_layer = layer
        fn = getattr(layer, "_orig_forward", None) or layer.forward
        if isinstance(fn, StaticFunction):
            fn = fn._fn
    else:
        model_layer, fn = None, layer

    if input_spec is None:
        spec_src = getattr(layer, "_static_function", None)
        input_spec = getattr(spec_src, "_input_spec", None)
    if input_spec is None:
        raise ValueError("jit.save requires input_spec (list of InputSpec or "
                         "example Tensors)")
    specs = [s if isinstance(s, InputSpec) else InputSpec.from_tensor(s)
             for s in input_spec]

    named = []
    was_training = False
    if model_layer is not None:
        was_training = model_layer.training
        model_layer.eval()
        named = list(model_layer.named_parameters()) + \
            [(n, b) for n, b in model_layer.named_buffers() if b is not None]
    names = [n for n, _ in named]
    tensors = [t for _, t in named]
    device = tensors[0]._value.device if tensors else torch_device()
    try:
        weights = [raw_value(t).detach() for t in tensors]
        examples = [s._example(device) for s in specs]
        metas = [(s.stop_gradient, s.name) for s in specs]
        dynamic = ([None] * len(weights),
                   [s._dynamic(k) for k, s in enumerate(specs)])
        ep = torch.export.export(_Exported(fn, tensors, metas),
                                 (weights, examples), dynamic_shapes=dynamic)
        blob = io.BytesIO()
        torch.export.save(ep, blob)
    finally:
        if model_layer is not None and was_training:
            model_layer.train()

    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path + _MODEL_SUFFIX, "wb") as f:
        pickle.dump({"program": blob.getvalue(), "param_names": names,
                     "param_dtypes": [str(w.dtype) for w in weights],
                     "input_specs": [(s.shape, str(s.dtype).replace(
                         "torch.", ""), s.name) for s in specs]}, f)
    with open(path + _PARAMS_SUFFIX, "wb") as f:
        pickle.dump({n: Tensor(w).numpy() for n, w in zip(names, weights)},
                    f)


class TranslatedLayer:
    """Reloaded inference program (paddle.jit.TranslatedLayer parity)."""

    def __init__(self, module, params: List[torch.Tensor],
                 param_names: List[str]):
        self._module = module
        self._params = params
        self._param_names = param_names
        self._input_specs = []

    def __call__(self, *args):
        dev = self._params[0].device if self._params else torch_device()
        vals = [a._value if isinstance(a, Tensor)
                else torch.as_tensor(np.asarray(a)) for a in args]
        vals = [v.to(dev) for v in vals]
        with torch.no_grad():
            outs = self._module(self._params, vals)
        wrapped = [_wrap(o) for o in outs]
        return wrapped[0] if len(wrapped) == 1 else tuple(wrapped)

    forward = __call__

    def eval(self):
        return self

    def train(self):
        raise RuntimeError("TranslatedLayer is an inference artifact; "
                           "re-train from the original model code")

    def parameters(self):
        return [_wrap(p) for p in self._params]

    def state_dict(self):
        return {n: _wrap(p) for n, p in zip(self._param_names, self._params)}


def load(path: str, device=None, **configs) -> TranslatedLayer:
    """``paddle.jit.load`` parity: reload a saved inference artifact on
    ``device`` (the current place when None)."""
    from ..kernels import ops  # noqa: F401 — registers the kernel ops
    with open(path + _MODEL_SUFFIX, "rb") as f:
        meta = pickle.load(f)
    with open(path + _PARAMS_SUFFIX, "rb") as f:
        weights = pickle.load(f)
    ep = torch.export.load(io.BytesIO(meta["program"]))
    dev = torch_device(device)
    params = [torch.as_tensor(weights[n]).to(
        device=dev, dtype=canonical_dtype(dt.replace("torch.", "")))
        for n, dt in zip(meta["param_names"], meta["param_dtypes"])]
    tl = TranslatedLayer(ep.module(), params, meta["param_names"])
    # the Predictor reads these without unpickling the artifact again
    tl._input_specs = meta.get("input_specs", [])
    return tl
