"""Legacy / long-tail op cluster — counterpart of
``paddle_tpu/ops/legacy.py``: batch-size-like creation ops, CTR ops (cvm,
data_norm, shuffle_batch), per-slot batch_fc, partial concat / sum, layout
shuffles, and newer entries (nonzero_static, fill_diagonal_tensor,
pca_lowrank).

Everything stays static-shape. The random ops (``pca_lowrank``,
``shuffle_batch``, ``sampling_id``, ``dropout_nd``, the batch-size-like
samplers) draw from the port's per-device generator (a ``seed`` argument
seeds a generator of its own on the input's device). Two ops compute on the
host, as the reference's do, and put their outputs on the input's device:
``unique_with_counts`` (its output shape is the data) and the metric
``chunk_eval``.
"""

from __future__ import annotations

import math as _math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.tensor import to_tensor
from ._helpers import Tensor, axes_arg, ensure_tensor, forward_op
from .random import generator

__all__ = [
    "exprel", "multigammaln", "reduce_as", "addbmm", "pca_lowrank",
    "im2col", "is_integer", "contiguous", "log_normal", "space_to_depth",
    "depth_to_space", "affine_channel", "data_norm", "fill_any",
    "fill_any_like", "unique_with_counts", "partial_concat", "partial_sum",
    "shuffle_batch", "batch_fc", "cvm", "sampling_id",
    "uniform_random_batch_size_like", "gaussian_random_batch_size_like",
    "fill_constant_batch_size_like", "dropout_nd",
    "fused_embedding_seq_pool", "nonzero_static", "fill_diagonal_tensor",
]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _generator(device, seed):
    """The port's generator of ``device``, or a fresh one seeded with
    ``seed`` when it is given."""
    if seed:
        return torch.Generator(device=device).manual_seed(int(seed))
    return generator(device)


def exprel(x, name=None):
    """(e^x - 1) / x, -> 1 at 0 (scipy.special.exprel parity)."""
    def impl(v):
        small = v.abs() < 1e-8
        safe = torch.where(small, torch.ones_like(v), v)
        return torch.where(small, 1.0 + v / 2, torch.expm1(safe) / safe)
    return forward_op("exprel", impl, [ensure_tensor(x)])


def multigammaln(x, p: int, name=None):
    """Log multivariate gamma (scipy.special.multigammaln parity)."""
    def impl(v):
        c = 0.25 * p * (p - 1) * _math.log(_math.pi)
        return c + sum(torch.lgamma(v - 0.5 * j) for j in range(p))
    return forward_op("multigammaln", impl, [ensure_tensor(x)])


def reduce_as(x, target, name=None):
    """Sum-reduce ``x`` down to ``target``'s shape (ref: paddle.reduce_as)."""
    def impl(v, t):
        extra = v.dim() - t.dim()
        if extra:
            v = v.sum(tuple(range(extra)))
        axes = tuple(i for i in range(v.dim())
                     if t.shape[i] == 1 and v.shape[i] != 1)
        return v.sum(axes, keepdim=True) if axes else v
    return forward_op("reduce_as", impl,
                      [ensure_tensor(x), ensure_tensor(target)])


def addbmm(input, x, y, beta: float = 1.0, alpha: float = 1.0, name=None):  # noqa: A002
    """beta*input + alpha*sum_b(x[b] @ y[b]) (torch.addbmm parity)."""
    return forward_op(
        "addbmm",
        lambda i, a, b: beta * i + alpha * torch.einsum("bik,bkj->ij", a, b),
        [ensure_tensor(input), ensure_tensor(x), ensure_tensor(y)])


def pca_lowrank(x, q=None, center: bool = True, niter: int = 2, name=None):
    """Randomized low-rank PCA -> (U, S, V) (torch.pca_lowrank parity; a
    power-iterated randomized range finder, all dense matmuls)."""
    xt = ensure_tensor(x)
    m, n = int(xt.shape[-2]), int(xt.shape[-1])
    q = q if q is not None else min(6, m, n)

    def impl(v):
        a = v - v.mean(-2, keepdim=True) if center else v
        omega = torch.randn((n, q), dtype=a.dtype, device=a.device,
                            generator=generator(a.device))
        y = a @ omega
        for _ in range(niter):
            y = a @ (a.mT @ y)
        qm, _ = torch.linalg.qr(y)
        u, s, vt = torch.linalg.svd(qm.mT @ a, full_matrices=False)
        return qm @ u, s, vt.mT
    return forward_op("pca_lowrank", impl, [xt])


def im2col(x, kernel_size, stride=1, padding=0, dilation=1, name=None):
    """Patch extraction [B, C, H, W] -> [B, C*kh*kw, L] (one ``F.unfold``)."""
    return forward_op(
        "im2col",
        lambda v: F.unfold(v, _pair(kernel_size), dilation=_pair(dilation),
                           padding=_pair(padding), stride=_pair(stride)),
        [ensure_tensor(x)])


def is_integer(x, name=None):
    """dtype predicate (ref: paddle.is_integer)."""
    v = ensure_tensor(x)._value
    return not (v.is_floating_point() or v.is_complex() or
                v.dtype == torch.bool)


def contiguous(x, name=None):
    """A contiguous copy (ref: paddle.Tensor.contiguous)."""
    return forward_op("contiguous", lambda v: v.contiguous(),
                      [ensure_tensor(x)])


def log_normal(mean=1.0, std=2.0, shape=None, name=None):
    """Log-normal sample (ref: paddle.log_normal)."""
    from .random import standard_normal
    out = standard_normal(shape if shape is not None else [1])
    return forward_op("log_normal", lambda v: torch.exp(v * std + mean),
                      [out])


def space_to_depth(x, blocksize: int, name=None):
    """[B, C, H, W] -> [B, C*bs*bs, H/bs, W/bs] (ref: space_to_depth_op)."""
    bs = blocksize

    def impl(v):
        B, C, H, W = v.shape
        v = v.reshape(B, C, H // bs, bs, W // bs, bs)
        return v.permute(0, 3, 5, 1, 2, 4).reshape(B, C * bs * bs, H // bs,
                                                   W // bs)
    return forward_op("space_to_depth", impl, [ensure_tensor(x)])


def depth_to_space(x, blocksize: int, name=None):
    """Inverse of space_to_depth."""
    bs = blocksize

    def impl(v):
        B, C, H, W = v.shape
        v = v.reshape(B, bs, bs, C // (bs * bs), H, W)
        return v.permute(0, 3, 4, 1, 5, 2).reshape(B, C // (bs * bs), H * bs,
                                                   W * bs)
    return forward_op("depth_to_space", impl, [ensure_tensor(x)])


def affine_channel(x, scale, bias, data_layout: str = "NCHW", name=None):
    """Per-channel scale + bias (ref: affine_channel_op)."""
    def impl(v, s, b):
        if data_layout == "NCHW":
            shape = (1, -1) + (1,) * (v.dim() - 2)
        else:
            shape = (1,) * (v.dim() - 1) + (-1,)
        return v * s.reshape(shape) + b.reshape(shape)
    return forward_op("affine_channel", impl,
                      [ensure_tensor(x), ensure_tensor(scale),
                       ensure_tensor(bias)])


def data_norm(x, batch_size, batch_sum, batch_square_sum,
              epsilon: float = 1e-4, name=None):
    """CTR data normalization by accumulated batch statistics; returns
    ``(out, new_size, new_sum, new_square_sum)``."""
    def impl(v, n, s, ss):
        mean = s / n
        var = ss / n - mean * mean
        out = (v - mean) / torch.sqrt(torch.clamp(var, min=epsilon))
        return out, n + v.shape[0], s + v.sum(0), ss + (v * v).sum(0)
    return forward_op("data_norm", impl,
                      [ensure_tensor(x), ensure_tensor(batch_size),
                       ensure_tensor(batch_sum),
                       ensure_tensor(batch_square_sum)])


def fill_any(x, value, name=None):
    """Fill with a runtime scalar (ref: fill_any_op)."""
    return forward_op(
        "fill_any",
        lambda v, val: torch.zeros_like(v) + val.to(v.dtype),
        [ensure_tensor(x), ensure_tensor(value)], differentiable=False)


def fill_any_like(x, value, dtype=None, name=None):
    """full_like under the legacy name (ref: fill_any_like_op)."""
    from ..core.dtype import canonical_dtype

    def impl(v):
        out = torch.full_like(v, value)
        return out if dtype is None else out.to(canonical_dtype(dtype))
    return forward_op("fill_any_like", impl, [ensure_tensor(x)],
                      differentiable=False)


def unique_with_counts(x, dtype="int32", name=None):
    """(unique values, inverse index, counts), computed on the host (the
    output shape is the data), on the input's device."""
    t = ensure_tensor(x)
    v, inv, cnt = np.unique(t.numpy(), return_inverse=True,
                            return_counts=True)
    return (to_tensor(v, place=t.place),
            to_tensor(inv.astype(np.int64), place=t.place),
            to_tensor(cnt.astype(np.int64), place=t.place))


def _partial(vs, start_index, length):
    stop = None if length < 0 else start_index + length
    return [v[:, start_index:stop] for v in vs]


def partial_concat(xs, start_index: int = 0, length: int = -1, name=None):
    """Concat x[:, start:start+length] of each input."""
    return forward_op(
        "partial_concat",
        lambda *vs: torch.cat(_partial(vs, start_index, length), -1),
        [ensure_tensor(x) for x in xs])


def partial_sum(xs, start_index: int = 0, length: int = -1, name=None):
    """Sum of x[:, start:start+length] across inputs."""
    def impl(*vs):
        sl = _partial(vs, start_index, length)
        return sum(sl[1:], sl[0])
    return forward_op("partial_sum", impl, [ensure_tensor(x) for x in xs])


def shuffle_batch(x, seed=None, name=None):
    """Random row permutation; returns (shuffled, permutation)."""
    t = ensure_tensor(x)
    dev = t._value.device
    perm = Tensor(torch.randperm(int(t.shape[0]), device=dev,
                                 generator=_generator(dev, seed)))
    out = forward_op("shuffle_batch", lambda v, p: v[p], [t, perm])
    return out, perm


def batch_fc(x, w, bias=None, name=None):
    """Per-slot FC: x [S, B, I] @ w [S, I, O] + b [S, O]."""
    args = [ensure_tensor(x), ensure_tensor(w)]
    if bias is not None:
        args.append(ensure_tensor(bias))

    def impl(xv, wv, *b):
        out = torch.bmm(xv, wv)
        return out + b[0][:, None, :] if b else out
    return forward_op("batch_fc", impl, args)


def cvm(x, cvm_input, use_cvm: bool = True, name=None):
    """Continuous-value-model feature transform: the first two columns are
    (show, click); use_cvm keeps them log-transformed, else drops them."""
    def impl(v, c):
        if not use_cvm:
            return v[:, 2:]
        show = torch.log(c[:, 0] + 1)
        click = torch.log(c[:, 1] + 1) - show
        return torch.cat([show[:, None], click[:, None], v[:, 2:]], -1)
    return forward_op("cvm", impl, [ensure_tensor(x), ensure_tensor(cvm_input)])


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="int64", name=None):  # noqa: A002
    """Sample one category id per row from probability rows."""
    def impl(v):
        p = v.to(torch.float64)
        p = p / p.sum(-1, keepdim=True)
        return torch.multinomial(p, 1, generator=_generator(v.device, seed)
                                 )[:, 0]
    return forward_op("sampling_id", impl, [ensure_tensor(x)],
                      differentiable=False)


def _batch_shape(input, shape, input_dim_idx, output_dim_idx):  # noqa: A002
    shape = list(shape)
    shape[output_dim_idx] = int(ensure_tensor(input).shape[input_dim_idx])
    return shape


def uniform_random_batch_size_like(input, shape, min=-1.0, max=1.0,  # noqa: A002
                                   input_dim_idx: int = 0,
                                   output_dim_idx: int = 0, dtype="float32",
                                   name=None):
    """Uniform sample whose dim ``output_dim_idx`` copies the input's batch."""
    from .random import uniform
    return uniform(_batch_shape(input, shape, input_dim_idx, output_dim_idx),
                   min=min, max=max, dtype=dtype)


def gaussian_random_batch_size_like(input, shape, mean=0.0, std=1.0,  # noqa: A002
                                    input_dim_idx: int = 0,
                                    output_dim_idx: int = 0,
                                    dtype="float32", name=None):
    """Gaussian twin of uniform_random_batch_size_like."""
    from .random import normal
    return normal(mean=mean, std=std,
                  shape=_batch_shape(input, shape, input_dim_idx,
                                     output_dim_idx))


def fill_constant_batch_size_like(input, shape, dtype, value,  # noqa: A002
                                  input_dim_idx: int = 0,
                                  output_dim_idx: int = 0, name=None):
    """Constant tensor with the input's batch size."""
    from .creation import full
    return full(_batch_shape(input, shape, input_dim_idx, output_dim_idx),
                value, dtype=dtype)


def dropout_nd(x, p: float = 0.5, axis=None, training: bool = True,
               mode: str = "upscale_in_train", name=None):
    """Dropout with the mask shared over the non-listed axes."""
    from ..nn import functional as NF
    if axis is None:
        return NF.dropout(x, p, training=training, mode=mode)
    t = ensure_tensor(x)
    if not training or p == 0.0:
        return forward_op("dropout_nd", lambda v: v, [t])
    axes = axes_arg(axis)
    axes = (axes,) if isinstance(axes, int) else axes

    def impl(v):
        shape = tuple(v.shape[d] if d in axes else 1 for d in range(v.dim()))
        keep = torch.rand(shape, device=v.device,
                          generator=generator(v.device)) < 1 - p
        kept = v / (1 - p) if mode == "upscale_in_train" else v
        return torch.where(keep, kept, torch.zeros_like(v))
    return forward_op("dropout_nd", impl, [t])


def fused_embedding_seq_pool(table, ids, pool_type: str = "sum",
                             padding_idx=None, name=None):
    """Embedding lookup + sequence pool in one op: ids [B, T] -> [B, D]."""
    def impl(tv, iv):
        emb = tv[torch.clamp(iv, 0, tv.shape[0] - 1).long()]
        if padding_idx is not None:
            emb = emb * (iv != padding_idx)[..., None].to(emb.dtype)
        if pool_type == "sum":
            return emb.sum(1)
        if pool_type in ("mean", "average"):
            n = ((iv != padding_idx).sum(1, keepdim=True)
                 if padding_idx is not None else
                 torch.full((iv.shape[0], 1), iv.shape[1], device=iv.device))
            return emb.sum(1) / torch.clamp(n, min=1).to(emb.dtype)
        raise ValueError(f"pool_type {pool_type!r}")
    return forward_op("fused_embedding_seq_pool", impl,
                      [ensure_tensor(table), ensure_tensor(ids)])


def nonzero_static(x, size: int, fill_value: int = -1, name=None):
    """Static-shape nonzero: the first ``size`` nonzero coordinates [size,
    ndim], padded with ``fill_value``."""
    def impl(v):
        flat = (v != 0).reshape(-1)
        idx = torch.sort((~flat).to(torch.int8), stable=True).indices[:size]
        coords = torch.stack(torch.unravel_index(idx, tuple(v.shape)), -1)
        ok = torch.arange(size, device=v.device) < flat.sum()
        return torch.where(ok[:, None], coords,
                           torch.full_like(coords, fill_value))
    return forward_op("nonzero_static", impl, [ensure_tensor(x)],
                      differentiable=False)


def fill_diagonal_tensor(x, y, offset: int = 0, dim1: int = 0,
                         dim2: int = 1, name=None):
    """Write ``y`` along the (dim1, dim2) diagonal."""
    def impl(v, w):
        vm = torch.movedim(v, (dim1, dim2), (-2, -1)).clone()
        n = min(vm.shape[-2], vm.shape[-1] - offset) if offset >= 0 \
            else min(vm.shape[-2] + offset, vm.shape[-1])
        r = torch.arange(max(n, 0), device=v.device)
        vm[..., r - min(offset, 0), r + max(offset, 0)] = w.to(v.dtype)
        return torch.movedim(vm, (-2, -1), (dim1, dim2))
    return forward_op("fill_diagonal_tensor", impl,
                      [ensure_tensor(x), ensure_tensor(y)])


# -- static-graph-era singles + CTR text matching -------------------------------

def fc(x, size: int, num_flatten_dims: int = 1, weight=None, bias=None,
       activation=None, name=None):
    """Static-graph fc layer op: flatten trailing dims, one matmul + bias +
    optional relu."""
    if weight is None:
        raise ValueError("fc: pass `weight` explicitly (the layer tier "
                         "owns parameter creation)")
    args = [ensure_tensor(x), ensure_tensor(weight)]
    if bias is not None:
        args.append(ensure_tensor(bias))

    def impl(v, w, *b):
        lead = tuple(v.shape[:num_flatten_dims])
        out = v.reshape(lead + (-1,)) @ w
        if b:
            out = out + b[0]
        return torch.relu(out) if activation == "relu" else out
    return forward_op("fc", impl, args)


def assign_value(shape, dtype, values, name=None):
    """Materialize a host constant (ref: assign_value_op)."""
    from ..core.dtype import canonical_dtype
    return to_tensor(torch.as_tensor(np.asarray(values)).to(
        canonical_dtype(dtype)).reshape(list(shape)))


def soft_relu(x, threshold: float = 40.0, name=None):
    """log(1 + e^x) with clipping (ref: soft_relu_op)."""
    return forward_op(
        "soft_relu",
        lambda v: torch.log1p(torch.exp(torch.clamp(v, -threshold,
                                                    threshold))),
        [ensure_tensor(x)])


def brelu(x, t_min: float = 0.0, t_max: float = 24.0, name=None):
    """Bounded relu (ref: brelu_op)."""
    return forward_op("brelu", lambda v: torch.clamp(v, t_min, t_max),
                      [ensure_tensor(x)])


def match_matrix_tensor(x, y, w, x_lens=None, y_lens=None, dim_t=None,
                        name=None):
    """Bilinear text-match tensor: for each channel t, score[b, t, i, j] =
    x[b, i] @ w[:, t] @ y[b, j] — one einsum."""
    return forward_op(
        "match_matrix_tensor",
        lambda xv, yv, wv: torch.einsum("bid,dte,bje->btij", xv, wv, yv),
        [ensure_tensor(x), ensure_tensor(y), ensure_tensor(w)])


def sequence_topk_avg_pooling(x, topks, channel_num: int = 1, name=None):
    """For each k in ``topks``, the mean of the k largest values over the
    last axis."""
    def impl(v):
        srt = torch.sort(v, dim=-1, descending=True).values
        return torch.stack([srt[..., :min(k, v.shape[-1])].mean(-1)
                            for k in topks], -1)
    return forward_op("sequence_topk_avg_pooling", impl, [ensure_tensor(x)])


def rank_attention(x, rank_offset, rank_param, max_rank: int = 3,
                   name=None):
    """Rank-aware attention projection: each row picks the parameter block
    of its (rank_i, rank_j) pair; one gather + batched matmul a pair."""
    def impl(xv, ov, pv):
        B, D = xv.shape
        blocks = pv.reshape(max_rank * max_rank, D, pv.shape[1])
        ins_rank = torch.clamp(ov[:, 0], 0, max_rank - 1)
        acc = torch.zeros((B, pv.shape[1]), dtype=xv.dtype, device=xv.device)
        cnt = torch.zeros((B, 1), dtype=xv.dtype, device=xv.device)
        for k in range(max_rank):
            # a rank_offset narrower than 1 + 2 * max_rank reads its last
            # column, as the reference's clamped gather does
            other = ov[:, min(1 + 2 * k, ov.shape[1] - 1)]
            valid = (other >= 0)[:, None]
            idx = torch.clamp(ins_rank * max_rank
                              + torch.clamp(other, 0, max_rank - 1), 0,
                              max_rank * max_rank - 1).long()
            proj = torch.einsum("bd,bdo->bo", xv, blocks[idx])
            acc = acc + torch.where(valid, proj, torch.zeros_like(proj))
            cnt = cnt + valid.to(xv.dtype)
        return acc / torch.clamp(cnt, min=1)
    return forward_op("rank_attention", impl,
                      [ensure_tensor(x), ensure_tensor(rank_offset),
                       ensure_tensor(rank_param)])


def tree_conv(nodes_vector, edge_set, filter, max_depth: int = 2,  # noqa: A002
              name=None):
    """Tree-based convolution (TBCNN): continuous binary-tree position
    weights over each node's children; adjacency as a dense [N, N] mask,
    one einsum per weight role (top / left / right)."""
    def impl(nv, ev, fv):
        B, N, _ = nv.shape
        par = torch.clamp(ev[..., 0], 0, N - 1).long()
        chl = torch.clamp(ev[..., 1], 0, N - 1).long()
        valid = ((ev[..., 0] >= 0) & (ev[..., 1] >= 0)).to(nv.dtype)
        b = torch.arange(B, device=nv.device)[:, None].expand_as(par)
        flat = (b * N * N + par * N + chl).reshape(-1)
        adj = torch.zeros(B * N * N, dtype=nv.dtype, device=nv.device
                          ).scatter_reduce(0, flat, valid.reshape(-1), "amax"
                                           ).reshape(B, N, N)
        deg = adj.sum(-1, keepdim=True)
        pos = torch.cumsum(adj, -1) * adj
        denom = torch.clamp(deg - 1, min=1)
        eta_r = (pos - 1) / denom * adj
        eta_l = (1 - (pos - 1) / denom) * adj
        h = (torch.einsum("bnd,do->bno", nv, fv[:, 0])
             + torch.einsum("bnm,bmd,do->bno", eta_l, nv, fv[:, 1])
             + torch.einsum("bnm,bmd,do->bno", eta_r, nv, fv[:, 2]))
        return torch.tanh(h)
    return forward_op("tree_conv", impl,
                      [ensure_tensor(nodes_vector), ensure_tensor(edge_set),
                       ensure_tensor(filter)])


def var_conv_2d(x, row_lens, col_lens, w, input_channel: int = 1,
                output_channel: int = 1, filter_size: int = 3,
                stride: int = 1, name=None):
    """Variable-size 2-D conv: conv at full capacity + the validity mask of
    the per-sample [row, col] sizes."""
    def impl(xv, rv, cv, wv):
        out = F.conv2d(xv, wv, stride=stride, padding=filter_size // 2)
        H, W = out.shape[2], out.shape[3]
        rm = torch.arange(H, device=xv.device)[None, :] < rv[:, None]
        cm = torch.arange(W, device=xv.device)[None, :] < cv[:, None]
        return out * (rm[:, None, :, None] & cm[:, None, None, :]).to(
            out.dtype)
    return forward_op("var_conv_2d", impl,
                      [ensure_tensor(x), ensure_tensor(row_lens),
                       ensure_tensor(col_lens), ensure_tensor(w)])


__all__ += ["fc", "assign_value", "soft_relu", "brelu",
            "match_matrix_tensor", "sequence_topk_avg_pooling",
            "rank_attention", "tree_conv", "var_conv_2d"]


# -- remaining singles -------------------------------------------------------------

def l1_norm(x, name=None):
    """Sum of absolute values (ref: l1_norm_op)."""
    return forward_op("l1_norm", lambda v: v.abs().sum(), [ensure_tensor(x)])


def share_data(x, name=None):
    """Alias of a tensor's value (ref: share_data_op)."""
    return forward_op("share_data", lambda v: v, [ensure_tensor(x)])


def lod_array_length(array, name=None):
    """Length of a TensorArray (ref: lod_array_length_op)."""
    from .array import array_length
    return array_length(array)


def set_value(x, value, name=None):
    """Overwrite a tensor's value in place (ref: set_value_op): rebinds it
    to ``value`` in its shape, dtype and place."""
    t = ensure_tensor(x)
    v = value if isinstance(value, Tensor) else to_tensor(
        np.asarray(value), place=t.place)
    out = forward_op("set_value",
                     lambda a, b: b.to(device=a.device, dtype=a.dtype
                                       ).reshape(a.shape), [t, v])
    t._rebind(out)
    return t


def bilinear_tensor_product(x, y, weight, bias=None, name=None):
    """out[b, k] = x[b] @ W[k] @ y[b] (ref: bilinear_tensor_product_op)."""
    args = [ensure_tensor(x), ensure_tensor(y), ensure_tensor(weight)]
    if bias is not None:
        args.append(ensure_tensor(bias))

    def impl(xv, yv, wv, *b):
        out = torch.einsum("bi,kij,bj->bk", xv, wv, yv)
        return out + b[0] if b else out
    return forward_op("bilinear_tensor_product", impl, args)


def _chunks(seq, num_chunk_types):
    """The IOB chunks of one tag sequence as (start, end, type): even tags
    begin a chunk of type tag // 2, odd tags continue it."""
    chunks, start, ctype = [], None, None
    for i, t in enumerate(list(seq) + [-1]):
        t = int(t)
        if t < 0 or t % 2 == 0:
            if start is not None:
                chunks.append((start, i, ctype))
                start, ctype = None, None
            if t >= 0 and t % 2 == 0 and t // 2 < num_chunk_types:
                start, ctype = i, t // 2
    return set(chunks)


def chunk_eval(input, label, chunk_scheme: str = "IOB",  # noqa: A002
               num_chunk_types: int = 1, excluded_chunk_types=None,
               seq_lens=None, name=None):
    """Chunk-level precision / recall / F1 for sequence labeling (IOB).
    A host metric, as the reference's: returns (precision, recall, f1,
    num_infer, num_label, num_correct) on the input's device."""
    it = ensure_tensor(input)
    iv, lv = it.numpy(), ensure_tensor(label).numpy()
    if iv.ndim == 1:
        iv, lv = iv[None], lv[None]
    lens = (ensure_tensor(seq_lens).numpy() if seq_lens is not None
            else np.full(iv.shape[0], iv.shape[1]))
    ni = nl = nc = 0
    for b in range(iv.shape[0]):
        ic = _chunks(iv[b, :lens[b]], num_chunk_types)
        lc = _chunks(lv[b, :lens[b]], num_chunk_types)
        ni, nl, nc = ni + len(ic), nl + len(lc), nc + len(ic & lc)
    p = nc / max(ni, 1)
    r = nc / max(nl, 1)
    f1 = 2 * p * r / max(p + r, 1e-12)
    place = it.place
    return (to_tensor(np.float32(p), place=place),
            to_tensor(np.float32(r), place=place),
            to_tensor(np.float32(f1), place=place),
            to_tensor(np.int64(ni), place=place),
            to_tensor(np.int64(nl), place=place),
            to_tensor(np.int64(nc), place=place))


__all__ += ["l1_norm", "share_data", "lod_array_length", "set_value",
            "bilinear_tensor_product", "chunk_eval"]
