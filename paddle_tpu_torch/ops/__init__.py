"""The op surface — counterpart of ``paddle_tpu/ops/__init__.py``.

The op modules populate ``core.dispatch.OP_REGISTRY`` under the
reference's names and patch their methods onto ``Tensor``, as the
reference assembles its tensor namespace; the generated in-place family
(``inplace``) reads the assembled surface, so it is imported last.
"""

import types as _types

from . import (array, creation, decode, extended, extras, legacy, linalg,
               logic, manipulation, math, quant, random, search, sequence,
               sets, special, windows)

_EXCLUDE = {"Tensor", "Parameter", "to_tensor", "ensure_tensor", "forward_op",
            "register_op", "patch_methods", "unary_factory", "binary_factory",
            "axes_arg", "dims_of", "canonical_dtype", "get_default_dtype",
            "get_device", "torch_device", "Generator", "default_generator",
            "generator", "OP_REGISTRY", "on_cuda"}


def _export(module):
    from ..core.dispatch import OP_REGISTRY, register_op
    names = []
    for k, v in vars(module).items():
        if k.startswith("_") or isinstance(v, _types.ModuleType) or k in _EXCLUDE:
            continue
        if getattr(v, "__module__", "") == "typing":
            continue
        globals()[k] = v
        names.append(k)
        if callable(v) and not isinstance(v, type) and k not in OP_REGISTRY:
            register_op(k, v, doc=(v.__doc__ or "").strip(), public=v)
        elif callable(v) and k in OP_REGISTRY and OP_REGISTRY[k].public is None:
            OP_REGISTRY[k].public = v
    return names


__all__ = sorted(set(
    _export(creation) + _export(math) + _export(manipulation) + _export(linalg)
    + _export(logic) + _export(search) + _export(random) + _export(extras)
    + _export(extended) + _export(sets) + _export(special)
    + _export(windows) + _export(sequence) + _export(quant)
    + _export(decode) + _export(legacy) + _export(array)))
# the inplace generator reads the assembled surface above — import it last
from . import inplace  # noqa: E402
__all__ = sorted(set(__all__ + _export(inplace)))
from .random import Generator, default_generator  # noqa: E402
from .creation import to_tensor  # noqa: E402
