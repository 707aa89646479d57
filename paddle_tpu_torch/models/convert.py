"""JAX parameter trees -> the port's tensors (through numpy, never jax).

The one way the tests hand the JAX package and the port the same weights:
the JAX side converts its pytree with ``jax.tree_util.tree_map(np.asarray,
params)`` and the port takes the numpy tree from there. Both fp trees and
weight-only-int8 trees (with ``*_s`` scale leaves) convert leaf by leaf.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..device import resolve_device
from .llama import LlamaConfig

__all__ = ["params_from_jax", "config_from_jax"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int8": torch.int8,
           "int32": torch.int32}


def _torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy/JAX dtype (or its name)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[np.dtype(dtype).name]


def _leaf(a, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # numpy has no native bf16
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))       # a writable copy
    return t.to(dev)


def params_from_jax(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """A (nested dict) JAX parameter tree of numpy-convertible arrays ->
    the same tree of tensors on ``device`` (dtypes kept)."""
    dev = resolve_device(device)
    return {k: params_from_jax(v, dev) if isinstance(v, dict)
            else _leaf(v, dev) for k, v in tree.items()}


def config_from_jax(cfg) -> LlamaConfig:
    """The port's :class:`LlamaConfig` for a JAX ``LlamaConfig`` (read by
    attribute; dtypes mapped through numpy)."""
    return LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads,
        num_key_value_heads=cfg.num_key_value_heads,
        max_position_embeddings=cfg.max_position_embeddings,
        rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta,
        tie_word_embeddings=cfg.tie_word_embeddings,
        use_fused_norm=cfg.use_fused_norm,
        dtype=_torch_dtype(cfg.dtype),
        param_dtype=_torch_dtype(cfg.param_dtype))
