"""nn.Layer — the module base class, counterpart of ``paddle_tpu/nn/layer.py``
(``python/paddle/nn/layer/layers.py`` in Paddle): auto-registration of
Parameters/sublayers via ``__setattr__``, buffers with persistability,
forward pre/post hooks, ``state_dict``/``set_state_dict``, train/eval
mode, ``apply``, named traversals, ``to`` and the dtype casts.

``set_state_dict`` takes the port's tensors, numpy arrays, or a JAX
``Layer``'s ``state_dict`` (anything ``np.asarray`` reads, which is how a
JAX array converts without this package importing JAX); see
``models/convert.py:state_dict_from_jax``.
"""

from __future__ import annotations

import warnings
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import torch

from ..core.dtype import canonical_dtype, get_default_dtype
from ..core.place import torch_device
from ..core.tensor import Parameter, Tensor

__all__ = ["Layer", "ParamAttr"]


@dataclass
class ParamAttr:
    """paddle.ParamAttr parity (reference: python/paddle/base/param_attr.py)."""
    name: Optional[str] = None
    initializer: Optional[Callable] = None
    learning_rate: float = 1.0
    regularizer: Any = None
    trainable: bool = True
    do_model_average: bool = True
    need_clip: bool = True

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if attr is False:
            return False
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if callable(attr):  # bare initializer
            return ParamAttr(initializer=attr)
        raise TypeError(f"invalid ParamAttr: {attr!r}")


class _HookHandle:
    _next_id = 0

    def __init__(self, hooks: Dict[int, Callable]):
        self._hooks = hooks
        self._id = _HookHandle._next_id
        _HookHandle._next_id += 1

    def remove(self):
        self._hooks.pop(self._id, None)


class Layer:
    def __init__(self, name_scope: Optional[str] = None, dtype=None):
        object.__setattr__(self, "_parameters", OrderedDict())
        object.__setattr__(self, "_sub_layers", OrderedDict())
        object.__setattr__(self, "_buffers", OrderedDict())
        self._non_persistable_buffer_names = set()
        self._forward_pre_hooks: Dict[int, Callable] = OrderedDict()
        self._forward_post_hooks: Dict[int, Callable] = OrderedDict()
        self.training = True
        self._dtype = canonical_dtype(dtype) or get_default_dtype()
        self._full_name = name_scope or self.__class__.__name__.lower()

    # -- registration -------------------------------------------------------
    def __setattr__(self, name: str, value: Any):
        params = self.__dict__.get("_parameters")
        layers = self.__dict__.get("_sub_layers")
        buffers = self.__dict__.get("_buffers")
        if isinstance(value, Parameter):
            if params is None:
                raise RuntimeError("call Layer.__init__ before assigning parameters")
            params[name] = value
            self.__dict__.pop(name, None)
        elif isinstance(value, Layer):
            if layers is None:
                raise RuntimeError("call Layer.__init__ before assigning sublayers")
            layers[name] = value
            self.__dict__.pop(name, None)
        else:
            if params is not None and name in params:
                if value is None:
                    del params[name]
                elif isinstance(value, Tensor):
                    params[name] = value  # allow rebinding a plain tensor slot
                else:
                    object.__setattr__(self, name, value)
                    return
            elif buffers is not None and name in buffers:
                buffers[name] = value
            else:
                object.__setattr__(self, name, value)

    def __getattr__(self, name: str):
        for store in ("_parameters", "_buffers", "_sub_layers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                return d[name]
        raise AttributeError(f"'{type(self).__name__}' object has no attribute {name!r}")

    def __delattr__(self, name):
        for store in ("_parameters", "_buffers", "_sub_layers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                del d[name]
                return
        object.__delattr__(self, name)

    def add_parameter(self, name: str, parameter: Optional[Parameter]) -> Optional[Parameter]:
        if parameter is not None and not isinstance(parameter, Parameter):
            raise TypeError("add_parameter expects a Parameter")
        self._parameters[name] = parameter
        return parameter

    def add_sublayer(self, name: str, sublayer: "Layer") -> "Layer":
        self._sub_layers[str(name)] = sublayer
        return sublayer

    def register_buffer(self, name: str, tensor: Optional[Tensor],
                        persistable: bool = True):
        self._buffers[name] = tensor
        if not persistable:
            self._non_persistable_buffer_names.add(name)

    def create_parameter(self, shape, attr=None, dtype=None, is_bias: bool = False,
                         default_initializer=None) -> Union[Parameter, None]:
        """Build a Parameter per ParamAttr (ref: Layer.create_parameter +
        LayerHelper in python/paddle/base/layer_helper_base.py)."""
        from . import initializer as I

        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        dt = canonical_dtype(dtype) or self._dtype
        shape = tuple(int(s) for s in shape)
        p = Parameter(torch.zeros(shape, dtype=dt, device=torch_device()),
                      trainable=attr.trainable, name=attr.name)
        init = attr.initializer or default_initializer
        if init is None:
            init = I._global_bias_init if is_bias else I._global_weight_init
        if init is None:
            init = I.Constant(0.0) if is_bias else I.XavierNormal()
        init(p)
        if attr.learning_rate != 1.0:
            p.optimize_attr = {"learning_rate": attr.learning_rate}
        if attr.regularizer is not None:
            p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p

    def create_tensor(self, name=None, persistable=None, dtype=None) -> Tensor:
        return Tensor(torch.zeros([0], dtype=canonical_dtype(dtype) or self._dtype,
                                  device=torch_device()))

    # -- traversal ----------------------------------------------------------
    def parameters(self, include_sublayers: bool = True) -> List[Parameter]:
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_parameters(self, prefix: str = "", include_sublayers: bool = True
                         ) -> Iterator[Tuple[str, Parameter]]:
        seen = set()
        for name, layer in self._traverse(prefix, include_sublayers):
            for pname, p in layer._parameters.items():
                if p is None or id(p) in seen:
                    continue
                seen.add(id(p))
                yield (f"{name}.{pname}" if name else pname), p

    def clear_gradients(self):
        """paddle.nn.Layer.clear_gradients parity."""
        for p in self.parameters():
            p.clear_grad()

    def buffers(self, include_sublayers: bool = True) -> List[Tensor]:
        return [b for _, b in self.named_buffers(include_sublayers=include_sublayers)]

    def named_buffers(self, prefix: str = "", include_sublayers: bool = True
                      ) -> Iterator[Tuple[str, Tensor]]:
        seen = set()
        for name, layer in self._traverse(prefix, include_sublayers):
            for bname, b in layer._buffers.items():
                if b is None or id(b) in seen:
                    continue
                seen.add(id(b))
                yield (f"{name}.{bname}" if name else bname), b

    def children(self) -> Iterator["Layer"]:
        for _, l in self.named_children():
            yield l

    def named_children(self) -> Iterator[Tuple[str, "Layer"]]:
        yield from self._sub_layers.items()

    def sublayers(self, include_self: bool = False) -> List["Layer"]:
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix: str = "", include_self: bool = False
                        ) -> Iterator[Tuple[str, "Layer"]]:
        for name, layer in self._traverse(prefix, True):
            if name == prefix and not include_self:
                continue
            yield name, layer

    def _traverse(self, prefix: str, include_sublayers: bool
                  ) -> Iterator[Tuple[str, "Layer"]]:
        yield prefix, self
        if include_sublayers:
            for name, sub in self._sub_layers.items():
                if sub is None:
                    continue
                sub_prefix = f"{prefix}.{name}" if prefix else name
                yield from sub._traverse(sub_prefix, True)

    def apply(self, fn: Callable[["Layer"], None]) -> "Layer":
        for l in self.children():
            l.apply(fn)
        fn(self)
        return self

    # -- state dict ---------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers: bool = True,
                   structured_name_prefix: str = "", use_hook: bool = True
                   ) -> Dict[str, Tensor]:
        out = destination if destination is not None else OrderedDict()
        for name, p in self.named_parameters(structured_name_prefix,
                                             include_sublayers):
            out[name] = p
        for name, layer in self._traverse(structured_name_prefix, include_sublayers):
            for bname, b in layer._buffers.items():
                if b is None or bname in layer._non_persistable_buffer_names:
                    continue
                out[(f"{name}.{bname}" if name else bname)] = b
        return out

    def set_state_dict(self, state_dict: Dict[str, Any], use_structured_name: bool = True):
        from ..models.convert import state_dict_from_jax
        own = self.state_dict()
        missing, unexpected = [], []
        for k, v in state_dict_from_jax(state_dict).items():
            if k not in own:
                unexpected.append(k)
                continue
            t = own[k]
            if tuple(v.shape) != tuple(t.shape):
                raise ValueError(f"shape mismatch for {k}: {v.shape} vs {t.shape}")
            t.set_value(v)
        for k in own:
            if k not in state_dict:
                missing.append(k)
        if missing or unexpected:
            warnings.warn(f"set_state_dict: missing={missing} unexpected={unexpected}")
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    # -- modes --------------------------------------------------------------
    def train(self):
        self.training = True
        for l in self.sublayers():
            l.training = True
        return self

    def eval(self):
        self.training = False
        for l in self.sublayers():
            l.training = False
        return self

    # -- dtype / device -----------------------------------------------------
    def to(self, device=None, dtype=None, blocking=None):
        """Move and/or cast every parameter and buffer (the Tensor objects
        stay; a parameter stays a leaf)."""
        dt = canonical_dtype(dtype)
        dev = torch_device(device) if device is not None else None
        for t in list(self.parameters()) + [b for b in self.buffers()
                                            if b is not None]:
            want = dt if dt is not None and t.is_floating_point() else None
            if want is not None or dev is not None:
                t._replace(t._value.to(device=dev, dtype=want), cast=True)
        return self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float(self):
        return self.to(dtype="float32")

    def half(self):
        return self.to(dtype="float16")

    def bfloat16(self):
        return self.to(dtype="bfloat16")

    # -- hooks & call -------------------------------------------------------
    def register_forward_pre_hook(self, hook) -> _HookHandle:
        h = _HookHandle(self._forward_pre_hooks)
        self._forward_pre_hooks[h._id] = hook
        return h

    def register_forward_post_hook(self, hook) -> _HookHandle:
        h = _HookHandle(self._forward_post_hooks)
        self._forward_post_hooks[h._id] = hook
        return h

    def __call__(self, *inputs, **kwargs):
        for hook in list(self._forward_pre_hooks.values()):
            res = hook(self, inputs)
            if res is not None:
                inputs = res if isinstance(res, tuple) else (res,)
        out = self.forward(*inputs, **kwargs)
        for hook in list(self._forward_post_hooks.values()):
            res = hook(self, inputs, out)
            if res is not None:
                out = res
        return out

    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def full_name(self) -> str:
        return self._full_name

    def extra_repr(self) -> str:
        return ""

    def __repr__(self):
        extra = self.extra_repr()
        lines = []
        for name, sub in self._sub_layers.items():
            sub_repr = repr(sub).split("\n")
            lines.append(f"  ({name}): " + ("\n  ".join(sub_repr)))
        main = f"{type(self).__name__}({extra}"
        if lines:
            return main + "\n" + "\n".join(lines) + "\n)"
        return main + ")"

    def __dir__(self):
        return list(super().__dir__()) + list(self._parameters) + \
            list(self._buffers) + list(self._sub_layers)
