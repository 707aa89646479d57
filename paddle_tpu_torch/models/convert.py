"""JAX parameter trees -> the port's tensors (through numpy, never jax).

The one way the tests hand the JAX package and the port the same weights
(the LLaMA tree through :func:`params_from_jax`, the BERT encoder's
through :func:`bert_params_from_jax`):
the JAX side converts its pytree with ``jax.tree_util.tree_map(np.asarray,
params)`` and the port takes the numpy tree from there. Both fp trees and
weight-only-int8 trees (with ``*_s`` scale leaves) convert leaf by leaf;
so does the AdamW state (:func:`opt_state_from_jax`). A JAX tree sharded
over a mesh converts the same way (``np.asarray`` of a sharded array is
its whole value), and :func:`specs_from_jax` reads a ``PartitionSpec``
tree as the port's spec tuples. :func:`to_numpy` goes back, for
comparisons (a sharded leaf assembled whole).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..device import resolve_device
from ..distributed.sharding import ShardedTensor, assemble
from .llama import LlamaConfig

__all__ = ["params_from_jax", "bert_params_from_jax", "config_from_jax",
           "opt_state_from_jax", "to_numpy", "specs_from_jax"]

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


def bert_params_from_jax(tree: Dict[str, Any], device=None
                         ) -> Dict[str, Any]:
    """A JAX ``bert_init_params`` tree (numpy-convertible) -> the port's
    :func:`~paddle_tpu_torch.models.bert.bert_encode` params on ``device``:
    the same stacked layout, fp32 leaves. Raises ``ValueError`` when a
    leaf the encoder reads is missing."""
    need = ("embed", "pos_embed", "ln_embed_w", "ln_embed_b", "layers",
            "pool_w", "pool_b")
    missing = [k for k in need if k not in tree]
    if missing:
        raise ValueError(f"bert_params_from_jax: not a BERT encoder tree "
                         f"(missing {missing})")
    out = params_from_jax(tree, device)
    return {k: ({n: t.to(torch.float32) for n, t in v.items()}
                if isinstance(v, dict) else v.to(torch.float32))
            for k, v in out.items()}


def opt_state_from_jax(state: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The JAX AdamW state ``{"m": tree, "v": tree, "step": int32 scalar}``
    (numpy-convertible) -> the port's, as ``llama._adamw_init`` lays it
    out."""
    dev = resolve_device(device)
    return {"m": params_from_jax(state["m"], dev),
            "v": params_from_jax(state["v"], dev),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=dev)}


def to_numpy(tree):
    """A (nested dict) tree of tensors or sharded leaves -> the same tree
    of whole numpy arrays on the host (bf16 as fp32: numpy has no bf16)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, ShardedTensor):
        tree = assemble(tree, "cpu")
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def specs_from_jax(tree):
    """A (nested dict) tree of JAX ``PartitionSpec`` (a tuple subclass) ->
    the same tree of plain tuples, the port's specs."""
    if isinstance(tree, dict):
        return {k: specs_from_jax(v) for k, v in tree.items()}
    return tuple(tree)


# JAX config fields whose feature the port does not run, with the value
# that means "off" (the serving tensor-parallel axis of a local config;
# the port's serving engine takes ServingConfig(tp=...))
_UNPORTED = {"tp_axis": None}


def config_from_jax(cfg) -> LlamaConfig:
    """The port's :class:`LlamaConfig` for a JAX ``LlamaConfig`` (read by
    attribute; dtypes mapped through numpy). Raises ``ValueError`` naming
    the field when the JAX config turns on a feature the port does not
    run (the serving tensor-parallel axis of a local config), rather than
    returning a config that computes something else."""
    for name, off in _UNPORTED.items():
        value = getattr(cfg, name, off)
        if value != off:
            raise ValueError(f"config_from_jax: {name}={value!r} is not "
                             f"supported by the port (only {name}={off!r})")
    return LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads,
        num_key_value_heads=cfg.num_key_value_heads,
        max_position_embeddings=cfg.max_position_embeddings,
        rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta,
        tie_word_embeddings=cfg.tie_word_embeddings,
        use_kernels=cfg.use_kernels, use_fused_norm=cfg.use_fused_norm,
        dtype=_torch_dtype(cfg.dtype),
        param_dtype=_torch_dtype(cfg.param_dtype),
        remat=cfg.remat, remat_policy=cfg.remat_policy,
        sep_axis=cfg.sep_axis, cp_impl=cfg.cp_impl,
        moe_num_experts=cfg.moe_num_experts, moe_top_k=cfg.moe_top_k,
        moe_capacity_factor=cfg.moe_capacity_factor,
        moe_aux_weight=cfg.moe_aux_weight, ep_axis=cfg.ep_axis,
        ce_chunks=cfg.ce_chunks)
