"""Random ops and the global RNG state — counterpart of
``paddle_tpu/ops/random.py``.

``paddle.seed(s)`` seeds one explicit ``torch.Generator`` per device
(made when a device first draws); initializers, dropout and the
``rand*`` ops draw from the generator of the device they fill. The same
seed gives the same draws; the draws are not ``jax.random``'s (the tests
carry weights across instead).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..core.dtype import canonical_dtype, get_default_dtype
from ..core.place import torch_device
from ..core.tensor import Tensor
from ._helpers import ensure_tensor, forward_op, patch_methods


class Generator:
    """Per-device ``torch.Generator`` set (``paddle.Generator`` parity)."""

    def __init__(self, seed: int = 0):
        self._seed = int(seed)
        self._gens: Dict[str, torch.Generator] = {}

    def manual_seed(self, seed: int):
        self._seed = int(seed)
        self._gens.clear()
        return self

    def initial_seed(self) -> int:
        return self._seed

    def for_device(self, device: torch.device) -> torch.Generator:
        key = str(device)
        g = self._gens.get(key)
        if g is None:
            g = torch.Generator(device=device).manual_seed(self._seed)
            self._gens[key] = g
        return g

    def get_state(self):
        return {k: g.get_state() for k, g in self._gens.items()}

    def set_state(self, state):
        for k, s in state.items():
            self.for_device(torch.device(k)).set_state(s)


_default_generator = Generator(0)


def default_generator() -> Generator:
    return _default_generator


def seed(s: int) -> Generator:
    """paddle.seed parity: reseed the global generator (every device)."""
    _default_generator.manual_seed(int(s))
    return _default_generator


def get_rng_state():
    return [_default_generator.get_state()]


def set_rng_state(state_list):
    _default_generator.set_state(state_list[0])


def generator(device=None) -> torch.Generator:
    """The global generator of ``device`` (the current place when None)."""
    dev = device if isinstance(device, torch.device) else torch_device(device)
    return _default_generator.for_device(dev)


def _float_dt(dtype):
    d = canonical_dtype(dtype)
    return d if d is not None else get_default_dtype()


def _shape(shape):
    from .creation import _shape_arg
    return _shape_arg(shape) if shape is not None else ()


def rand(shape, dtype=None, name=None) -> Tensor:
    return uniform(shape, dtype, min=0.0, max=1.0)


def randn(shape, dtype=None, name=None) -> Tensor:
    return standard_normal(shape, dtype)


def standard_normal(shape, dtype=None, name=None) -> Tensor:
    dev = torch_device()
    return Tensor(torch.randn(_shape(shape), generator=generator(dev),
                              dtype=_float_dt(dtype), device=dev))


def normal(mean=0.0, std=1.0, shape=None, name=None) -> Tensor:
    dev = torch_device()
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        m = ensure_tensor(mean)._value
        s = ensure_tensor(std)._value
        shp = torch.broadcast_shapes(m.shape, s.shape)
        z = torch.randn(shp, generator=generator(m.device),
                        dtype=get_default_dtype(), device=m.device)
        return Tensor((m + s * z).detach())
    z = torch.randn(_shape(shape), generator=generator(dev),
                    dtype=get_default_dtype(), device=dev)
    return Tensor(mean + std * z)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None) -> Tensor:  # noqa: A002
    dev = torch_device()
    gen = torch.Generator(device=dev).manual_seed(seed) if seed else \
        generator(dev)
    lo = min.item() if isinstance(min, Tensor) else min
    hi = max.item() if isinstance(max, Tensor) else max
    return Tensor(torch.empty(_shape(shape), dtype=_float_dt(dtype),
                              device=dev).uniform_(lo, hi, generator=gen))


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None) -> Tensor:
    if high is None:
        low, high = 0, low
    dev = torch_device()
    return Tensor(torch.randint(int(low), int(high), _shape(shape),
                                generator=generator(dev),
                                dtype=canonical_dtype(dtype), device=dev))


def randint_like(x, low=0, high=None, dtype=None, name=None) -> Tensor:
    x = ensure_tensor(x)
    dt = canonical_dtype(dtype) or x.dtype
    if high is None:
        low, high = 0, low
    v = x._value
    return Tensor(torch.randint(int(low), int(high), tuple(v.shape),
                                generator=generator(v.device),
                                device=v.device).to(dt))


def randperm(n, dtype="int64", name=None) -> Tensor:
    dev = torch_device()
    return Tensor(torch.randperm(int(n), generator=generator(dev),
                                 device=dev).to(canonical_dtype(dtype)))


def bernoulli(x, name=None) -> Tensor:
    x = ensure_tensor(x)
    gen = generator(x._value.device)
    return forward_op("bernoulli",
                      lambda v: torch.bernoulli(v, generator=gen),
                      [x], differentiable=False)


def bernoulli_(x, p=0.5, name=None) -> Tensor:
    v = x._value
    draw = torch.rand(v.shape, generator=generator(v.device),
                      device=v.device) < p
    return x.set_value(draw.to(v.dtype))


def poisson(x, name=None) -> Tensor:
    x = ensure_tensor(x)
    v = x._value.detach()
    return Tensor(torch.poisson(v, generator=generator(v.device)))


def multinomial(x, num_samples=1, replacement=False, name=None) -> Tensor:
    x = ensure_tensor(x)
    v = x._value.detach()
    return Tensor(torch.multinomial(v, num_samples, replacement=replacement,
                                    generator=generator(v.device)))


def exponential_(x, lam=1.0, name=None) -> Tensor:
    v = x._value
    e = torch.empty(v.shape, dtype=torch.float32, device=v.device
                    ).exponential_(1.0, generator=generator(v.device))
    return x.set_value(e / lam)


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None) -> Tensor:  # noqa: A002
    v = x._value
    u = torch.empty(v.shape, device=v.device).uniform_(
        min, max, generator=generator(v.device))
    return x.set_value(u)


def normal_(x, mean=0.0, std=1.0, name=None) -> Tensor:
    v = x._value
    z = torch.randn(v.shape, generator=generator(v.device), device=v.device)
    return x.set_value(mean + std * z)


def rand_like(x, dtype=None, name=None) -> Tensor:
    x = ensure_tensor(x)
    v = x._value
    return Tensor(torch.rand(v.shape, generator=generator(v.device),
                             dtype=canonical_dtype(dtype) or v.dtype,
                             device=v.device))


def randn_like(x, dtype=None, name=None) -> Tensor:
    x = ensure_tensor(x)
    v = x._value
    return Tensor(torch.randn(v.shape, generator=generator(v.device),
                              dtype=canonical_dtype(dtype) or v.dtype,
                              device=v.device))


patch_methods([
    ("bernoulli_", bernoulli_), ("exponential_", exponential_),
    ("uniform_", uniform_), ("normal_", normal_), ("multinomial", multinomial),
])
