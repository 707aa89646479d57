"""The sparse (point-cloud) convolution family — counterpart of
``paddle_tpu/sparse/nn_conv.py``: ``conv3d``, ``subm_conv3d``,
``max_pool3d`` and ``batch_norm`` over COO voxel grids (``[B, D, H, W,
C]``, NDHWC), and the layers ``Conv3D``, ``SubmConv3D``, ``BatchNorm`` and
``MaxPool3D`` (the SECOND / sparse-CNN workload).

The reference's structure stays: a rulebook of (input row, output row)
pairs for each kernel offset, then one ``[P_k, Cin] @ [Cin, Cout]`` a
offset and a scatter-add. Where the reference builds the rulebook in
Python loops over voxels and pads every offset to the largest pair count,
here it is built on the device and kept ragged:

* coordinates ``(b, z, y, x)`` become int64 keys (``_keys.linearize``);
* a strided conv's outputs are the ``unique`` of every input's candidate
  outputs over the taps, in sorted key order (as Paddle's GPU kernel
  gives them; the reference keeps insertion order); a submanifold conv's
  outputs are its inputs, in their order;
* each output's input at each tap is found by ``searchsorted`` into the
  sorted input keys, all taps at once;
* the pairs, grouped by offset, come out of one ``nonzero_static`` over
  the found mask, whose size is the one host read of the per-offset
  counts. A strided conv reads the count of its outputs too (the
  ``unique``); a ``max_pool3d`` the same. Both reads are counted in
  ``_keys.syncs``; nothing else leaves the device.

A rulebook is cached on the input's indices tensor (the key holds the
geometry and the tensor's version): the submanifold convs of one level,
and the BatchNorm and ReLU between them, share one indices tensor, so they
share one rulebook, as Paddle's ``key`` argument shares it.

Each offset's product is a gather, a matmul and an ``index_add_``;
gradients flow through the values and the weights (indices carry none, as
upstream). Within one offset each output row takes at most one pair and
each input row gives at most one, so neither the ``index_add_`` nor the
gather's backward has two atomics on one row, and the offsets run one
after another: a run on the card is deterministic. It differs from the
CPU's by the order in which the matmuls and reductions sum. ``BatchNorm``'s
running statistics are device buffers updated in place (the reference
reads them to the host on every training forward).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.tensor import Parameter, Tensor, _wrap
from ..nn.layer import Layer
from ..ops._helpers import ensure_tensor, forward_op, register_op
from . import _keys

__all__ = ["conv3d", "subm_conv3d", "max_pool3d", "batch_norm",
           "Conv3D", "SubmConv3D", "BatchNorm", "MaxPool3D"]


def _triple(v) -> Tuple[int, int, int]:
    return (int(v),) * 3 if isinstance(v, (int, np.integer)) else \
        tuple(int(s) for s in v)


class _Rulebook:
    """The pairs of one sparse conv or pool: ``pin`` / ``pout`` (int64 rows
    of the input and output values) grouped by kernel offset, ``counts``
    the pairs of each offset (host ints), the output's indices tensor
    (None for a submanifold conv, whose output takes the input's: the
    cache on that tensor holds no reference back to it) and its row
    count."""
    __slots__ = ("out_indices", "m", "pin", "pout", "counts")

    def __init__(self, out_indices, m, pin, pout, counts):
        self.out_indices, self.m = out_indices, m
        self.pin, self.pout, self.counts = pin, pout, counts


def _out_dims(dims, kernel, stride, padding):
    return tuple((d + 2 * p - k) // s + 1
                 for d, k, s, p in zip(dims, kernel, stride, padding))


def _taps(kernel, device):
    """Every kernel offset ``(dz, dy, dx)`` ``[K, 3]``, in the weight's
    ``(dz * kh + dy) * kw + dx`` order."""
    kd, kh, kw = kernel
    g = torch.stack(torch.meshgrid(torch.arange(kd), torch.arange(kh),
                                   torch.arange(kw), indexing="ij"), -1)
    return g.reshape(-1, 3).to(device)


def rulebook(x, kernel, stride, padding, subm: bool) -> _Rulebook:
    """The rulebook of ``x`` (a COO ``[B, D, H, W, C]``) for one conv or
    pool geometry, built on ``x``'s device and cached on its indices."""
    idx_t = x.indices_
    B, D, H, W = x.shape[:4]
    key = (kernel, stride, padding, subm, B, D, H, W, idx_t._version)
    cache = idx_t.__dict__.setdefault("_rulebooks", {})
    if key in cache:
        return cache[key]
    idx = idx_t._value.long()                                   # [4, N]
    dev = idx.device
    n = idx.shape[1]
    stride_t = torch.tensor(stride, device=dev)[:, None, None]
    pad_t = torch.tensor(padding, device=dev)[:, None, None]
    taps = _taps(kernel, dev).t()[:, :, None]                   # [3, K, 1]
    in_keys = _keys.linearize(idx, (B, D, H, W))
    sorted_keys, order = torch.sort(in_keys)
    if subm:
        out_indices, m = None, n
        ob, out_sp = idx[:1], idx[1:]
    else:
        od = _out_dims((D, H, W), kernel, stride, padding)
        # every input's candidate output through each tap
        num = idx[1:, None, :] + pad_t - taps                  # [3, K, N]
        cand = torch.div(num, stride_t, rounding_mode="floor")
        valid = ((num % stride_t == 0) & (cand >= 0) &
                 (cand < torch.tensor(od, device=dev)[:, None, None])
                 ).all(0)
        ckey = _keys.linearize(torch.cat([idx[:1, None, :].expand(
            1, cand.shape[1], n), cand]), (B,) + od)
        # an invalid candidate repeats the least valid key, which the
        # set holds anyway; no candidate at all is the one case where
        # that key (the int64 maximum) must be read back
        top = torch.iinfo(torch.int64).max
        least = ckey.masked_fill(~valid, top).min()
        uniq = _keys.counted_unique(torch.where(valid, ckey, least)
                                    .reshape(-1))
        m = int(uniq.numel())
        if m == 1 and _keys.host_equal(uniq, torch.full_like(uniq, top)):
            uniq, m = uniq[:0], 0
        out_full = _keys.unravel(uniq, (B,) + od)
        out_indices = _wrap(out_full)
        ob, out_sp = out_full[:1].long(), out_full[1:].long()
    if m == 0 or n == 0:
        empty = torch.zeros(0, dtype=torch.long, device=dev)
        rb = _Rulebook(out_indices, m, empty, empty,
                       [0] * int(np.prod(kernel)))
        cache[key] = rb
        return rb
    # each output's input at each tap: i = o * stride - padding + tap
    src = out_sp[:, None, :] * stride_t - pad_t + taps           # [3, K, M]
    inside = ((src >= 0) & (src < torch.tensor(
        (D, H, W), device=dev)[:, None, None])).all(0)
    q = _keys.linearize(torch.cat([ob[:, None, :].expand(1, src.shape[1], m),
                                   src]), (B, D, H, W))
    pos = torch.searchsorted(sorted_keys, q).clamp_(max=n - 1)
    found = inside & (sorted_keys[pos] == q)                     # [K, M]
    counts = _keys.host_sizes(found.sum(1))
    flat = torch.nonzero_static(found.reshape(-1),
                                size=int(sum(counts))).reshape(-1)
    pin = order[pos.reshape(-1)[flat]]
    pout = flat % m
    rb = _Rulebook(out_indices, m, pin, pout, counts)
    cache[key] = rb
    return rb


def _sparse_conv(x, weight, bias, kernel, stride, padding, subm):
    from . import SparseCooTensor
    if not isinstance(x, SparseCooTensor):
        raise TypeError("sparse conv expects a SparseCooTensor")
    B, D, H, W, _ = x.shape
    wt = ensure_tensor(weight)          # [kd, kh, kw, Cin, Cout]
    cout = int(wt.shape[-1])
    rb = rulebook(x, kernel, stride, padding, subm)
    args = [x.values(), wt] + ([ensure_tensor(bias)] if bias is not None
                               else [])

    def impl(v, w, *b):
        wk = w.reshape(len(rb.counts), v.shape[-1], -1)      # [K, Cin, Cout]
        out = torch.zeros((rb.m, wk.shape[-1]), dtype=v.dtype,
                          device=v.device)
        start = 0
        for k, cnt in enumerate(rb.counts):
            if cnt:
                seg = slice(start, start + cnt)
                out.index_add_(0, rb.pout[seg],
                               v.index_select(0, rb.pin[seg]) @ wk[k])
            start += cnt
        if b:
            out = out + b[0]
        return out

    out_vals = forward_op("sparse_subm_conv3d" if subm else "sparse_conv3d",
                          impl, args)
    if subm:
        return SparseCooTensor(x.indices_, out_vals, [B, D, H, W, cout])
    return SparseCooTensor(rb.out_indices, out_vals,
                           [B, *_out_dims((D, H, W), kernel, stride, padding),
                            cout], coalesced=True)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1,
           groups: int = 1, data_format="NDHWC", name=None):
    """Sparse 3-D convolution over a COO voxel grid: the active outputs are
    every site some kernel tap reaches from an active input."""
    if dilation not in (1, (1, 1, 1)) or groups != 1:
        raise NotImplementedError("sparse conv3d: dilation/groups TBD")
    k = tuple(int(s) for s in ensure_tensor(weight).shape[:3])
    return _sparse_conv(x, weight, bias, k, _triple(stride),
                        _triple(padding), subm=False)


def subm_conv3d(x, weight, bias=None, stride=1, padding=None, dilation=1,
                groups: int = 1, data_format="NDHWC", name=None):
    """Submanifold sparse conv: the output sites are the input sites (the
    active set does not dilate). ``padding`` defaults to same-centre
    (k // 2); stride must be 1."""
    k = tuple(int(s) for s in ensure_tensor(weight).shape[:3])
    if padding is None:
        padding = tuple(s // 2 for s in k)
    if _triple(stride) != (1, 1, 1):
        raise ValueError("subm_conv3d requires stride 1 (the submanifold "
                         "contract)")
    return _sparse_conv(x, weight, bias, k, (1, 1, 1), _triple(padding),
                        subm=True)


def max_pool3d(x, kernel_size, stride=None, padding=0,
               data_format="NDHWC", name=None):
    """Sparse max pooling: the max over each output site's active taps."""
    from . import SparseCooTensor
    k = _triple(kernel_size)
    s = _triple(stride) if stride is not None else k
    p = _triple(padding)
    B, D, H, W, C = x.shape
    rb = rulebook(x, k, s, p, subm=False)

    def impl(v):
        src = v.index_select(0, rb.pin)
        return torch.zeros((rb.m, v.shape[-1]), dtype=v.dtype,
                           device=v.device).scatter_reduce(
            0, rb.pout[:, None].expand(-1, v.shape[-1]), src, "amax",
            include_self=False)

    vals = forward_op("sparse_max_pool3d", impl, [x.values()])
    return SparseCooTensor(rb.out_indices, vals,
                           [B, *_out_dims((D, H, W), k, s, p), C],
                           coalesced=True)


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training: bool = False, momentum: float = 0.9,
               epsilon: float = 1e-5, name=None):
    """BatchNorm over the values of a COO tensor (statistics over the
    active sites only). Returns ``(out, new_mean, new_var)``; the running
    statistics move only when ``training``."""
    from . import SparseCooTensor
    args = [x.values(), ensure_tensor(running_mean),
            ensure_tensor(running_var)]
    if weight is not None:
        args.append(ensure_tensor(weight))
    if bias is not None:
        args.append(ensure_tensor(bias))

    def impl(v, rm, rv, *wb):
        if training:
            mean = v.mean(0)
            var = v.var(0, unbiased=False)
            new_rm = momentum * rm + (1 - momentum) * mean
            new_rv = momentum * rv + (1 - momentum) * var
        else:
            mean, var = rm, rv
            new_rm, new_rv = rm, rv
        out = (v - mean) / torch.sqrt(var + epsilon)
        i = 0
        if weight is not None:
            out = out * wb[i]
            i += 1
        if bias is not None:
            out = out + wb[i]
        return out, new_rm, new_rv

    out_vals, nrm, nrv = forward_op("sparse_batch_norm", impl, args)
    return SparseCooTensor(x.indices(), out_vals, x.shape), nrm, nrv


# -- the layers ---------------------------------------------------------------

class _SparseConvBase(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, bias_attr=True, seed: int = 0):
        super().__init__()
        k = _triple(kernel_size)
        rng = np.random.default_rng(seed)
        bound = 1.0 / np.sqrt(in_channels * k[0] * k[1] * k[2])
        self.weight = Parameter(rng.uniform(
            -bound, bound, k + (in_channels, out_channels)).astype(np.float32))
        self.bias = Parameter(np.zeros(out_channels, np.float32)) \
            if bias_attr else None
        self.stride = stride
        self.padding = padding


class Conv3D(_SparseConvBase):
    """``paddle.sparse.nn.Conv3D`` (weight ``[kd, kh, kw, Cin, Cout]``)."""

    def forward(self, x):
        return conv3d(x, self.weight, self.bias, self.stride, self.padding)


class SubmConv3D(_SparseConvBase):
    """``paddle.sparse.nn.SubmConv3D``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=None, bias_attr=True, seed: int = 0):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, bias_attr, seed)

    def forward(self, x):
        return subm_conv3d(x, self.weight, self.bias, self.stride,
                           self.padding)


class BatchNorm(Layer):
    """``paddle.sparse.nn.BatchNorm``: ``weight`` / ``bias`` and the running
    ``_mean`` / ``_var`` buffers, on the current place."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5):
        super().__init__()
        self.weight = Parameter(np.ones(num_features, np.float32))
        self.bias = Parameter(np.zeros(num_features, np.float32))
        self.register_buffer("_mean", Tensor(np.zeros(num_features,
                                                      np.float32)))
        self.register_buffer("_var", Tensor(np.ones(num_features,
                                                    np.float32)))
        self.momentum = momentum
        self.epsilon = epsilon

    def forward(self, x):
        out, nrm, nrv = batch_norm(
            x, self._mean, self._var, self.weight, self.bias,
            training=self.training, momentum=self.momentum,
            epsilon=self.epsilon)
        if self.training:
            self._mean.set_value(nrm.detach())
            self._var.set_value(nrv.detach())
        return out


class MaxPool3D(Layer):
    """``paddle.sparse.nn.MaxPool3D``."""

    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding

    def forward(self, x):
        return max_pool3d(x, self.kernel_size, self.stride, self.padding)


for _n, _f in (("sparse_conv3d", conv3d),
               ("sparse_subm_conv3d", subm_conv3d),
               ("sparse_max_pool3d", max_pool3d),
               ("sparse_batch_norm", batch_norm)):
    register_op(_n, _f, (_f.__doc__ or "").strip().split("\n")[0],
                category="sparse", public=_f)
