"""``paddle.sparse`` — counterpart of ``paddle_tpu/sparse/__init__.py``:
COO and CSR tensors, their conversions and math, ``sparse.nn`` (the
activations, row softmax, masked attention and the convolution family of
``nn_conv.py``).

A ``SparseCooTensor`` holds ``indices [sparse_dim, nnz]`` (int32, as the
reference keeps them) and ``values [nnz, ...]`` (dense trailing dims: the
hybrid layout of every sparse-conv output); a ``SparseCsrTensor`` holds
``crows``, ``cols`` (int32) and ``values``. Every structural step runs on
the tensors' device, where the reference works in host numpy: coordinates
become int64 keys (``_keys.py``), ``coalesce`` and the union of two
patterns are ``torch.unique(return_inverse=True)`` plus ``index_add``,
CSR rows come from a sorted ``argsort`` and a ``searchsorted`` of the row
pointer. A result whose nnz the data decides reads that one size to the
host (counted in ``_keys.syncs``); no index is read otherwise.

The math keeps Paddle's contract where the reference departs from it
(ROADMAP §C): ``sparse_coo_tensor`` infers a hybrid shape with the
values' dense dims; ``to_dense`` takes hybrid tensors; ``add`` /
``subtract`` / ``multiply`` keep the union pattern, zeros that the sum
makes included, without densifying; the unary family and ``relu`` take
CSR as well as COO. Sparse-dense products are gathers, a scale and a
segment sum over the stored entries (``index_add``); ``masked_matmul``
computes only the sampled dot products. ``attention`` turns the CSR
pattern into a dense boolean mask on the device (cached on the mask
object) inside the plain masked attention, as the reference does; with a
mask it never takes the flash kernels.
"""

from __future__ import annotations

import math as _math
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.tensor import Tensor, _wrap
from ..nn.layer import Layer
from ..ops._helpers import ensure_tensor, forward_op, register_op
from . import _keys

__all__ = ["SparseCooTensor", "SparseCsrTensor", "sparse_coo_tensor",
           "sparse_csr_tensor", "is_same_shape", "add", "subtract",
           "multiply", "divide", "matmul", "masked_matmul", "mv", "addmm",
           "relu", "coalesce", "sin", "tan", "asin", "atan", "sinh", "tanh",
           "asinh", "atanh", "sqrt", "square", "log1p", "abs", "expm1",
           "deg2rad", "rad2deg", "neg", "pow", "cast", "sum", "transpose",
           "reshape", "nn"]


def _int32(t) -> Tensor:
    t = ensure_tensor(t)
    return t if t._value.dtype == torch.int32 else t.astype("int32")


class SparseCooTensor:
    """COO sparse tensor: ``indices [sparse_dim, nnz]`` + ``values [nnz,
    ...]``."""

    def __init__(self, indices: Tensor, values: Tensor, shape: Sequence[int],
                 coalesced: bool = False):
        self.indices_ = _int32(indices)
        self.values_ = ensure_tensor(values)
        self.shape = list(int(s) for s in shape)
        self._coalesced = coalesced

    def indices(self) -> Tensor:
        return self.indices_

    def values(self) -> Tensor:
        return self.values_

    def nnz(self) -> int:
        return int(self.values_.shape[0])

    @property
    def dtype(self):
        return self.values_.dtype

    @property
    def ndim(self):
        return len(self.shape)

    def is_sparse(self):
        return True

    def is_sparse_coo(self):
        return True

    def is_sparse_csr(self):
        return False

    def _sparse_dims(self):
        return self.shape[:int(self.indices_.shape[0])]

    def to_dense(self) -> Tensor:
        shape = tuple(self.shape)
        nd = int(self.indices_.shape[0])

        def f(idx, vals):
            dense = torch.zeros(shape, dtype=vals.dtype, device=vals.device)
            return dense.index_put(tuple(idx[d].long() for d in range(nd)),
                                   vals, accumulate=True)
        return forward_op("sparse_to_dense", f, [self.indices_, self.values_])

    def to_sparse_csr(self) -> "SparseCsrTensor":
        if self.ndim != 2:
            raise ValueError("to_sparse_csr requires a 2-D COO tensor")
        idx = self.indices_._value
        order = torch.argsort(_keys.linearize(idx, self.shape), stable=True)
        rows, cols = idx[0][order], idx[1][order]
        crows = torch.searchsorted(
            rows, torch.arange(self.shape[0] + 1, device=idx.device,
                               dtype=rows.dtype)).to(torch.int32)
        vals = forward_op("csr_sort", lambda v: v[order], [self.values_])
        return SparseCsrTensor(_wrap(crows), _wrap(cols), vals, self.shape)

    def coalesce(self) -> "SparseCooTensor":
        """Merge duplicate coordinates (their values summed), sorted."""
        dims = self._sparse_dims()
        uniq, inv = _keys.counted_unique(
            _keys.linearize(self.indices_._value, dims), return_inverse=True)
        m = int(uniq.numel())

        def f(vals):
            return torch.zeros((m,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                               device=vals.device).index_add(0, inv, vals)
        new_vals = forward_op("sparse_coalesce", f, [self.values_])
        return SparseCooTensor(_wrap(_keys.unravel(uniq, dims)), new_vals,
                               self.shape, coalesced=True)

    def __repr__(self):
        return (f"SparseCooTensor(shape={self.shape}, nnz={self.nnz()}, "
                f"dtype={self.dtype})")


class SparseCsrTensor:
    """CSR sparse matrix: crows [rows+1], cols [nnz], values [nnz]."""

    def __init__(self, crows: Tensor, cols: Tensor, values: Tensor,
                 shape: Sequence[int]):
        self.crows_ = _int32(crows)
        self.cols_ = _int32(cols)
        self.values_ = ensure_tensor(values)
        self.shape = list(int(s) for s in shape)

    def crows(self):
        return self.crows_

    def cols(self):
        return self.cols_

    def values(self):
        return self.values_

    def nnz(self):
        return int(self.values_.shape[0])

    @property
    def dtype(self):
        return self.values_.dtype

    def is_sparse_csr(self):
        return True

    def is_sparse_coo(self):
        return False

    def _rows(self) -> torch.Tensor:
        return _keys.csr_rows(self.crows_._value, self.nnz())

    def to_dense(self) -> Tensor:
        rows = self._rows()
        shape = tuple(self.shape)

        def f(cols, vals):
            dense = torch.zeros(shape, dtype=vals.dtype, device=vals.device)
            return dense.index_put((rows, cols.long()), vals,
                                   accumulate=True)
        return forward_op("csr_to_dense", f, [self.cols_, self.values_])

    def to_sparse_coo(self, sparse_dim: Optional[int] = None
                      ) -> SparseCooTensor:
        idx = torch.stack([self._rows().to(torch.int32), self.cols_._value])
        return SparseCooTensor(_wrap(idx), self.values_, self.shape)

    def __repr__(self):
        return (f"SparseCsrTensor(shape={self.shape}, nnz={self.nnz()}, "
                f"dtype={self.dtype})")


def sparse_coo_tensor(indices, values, shape=None, dtype=None, place=None,
                      stop_gradient=True) -> SparseCooTensor:
    """A COO tensor; with no ``shape``, the extent of each sparse dim
    (one counted host read of the indices' maxima) followed by the
    values' dense dims, as Paddle infers it."""
    from ..core.tensor import to_tensor
    idx = indices if isinstance(indices, Tensor) and place is None else \
        to_tensor(indices, place=place)
    vals = values if isinstance(values, Tensor) and place is None else \
        to_tensor(values, place=place)
    if dtype is not None:
        vals = vals.astype(dtype)
    if shape is None:
        extent = _keys.host_sizes(idx._value.amax(dim=1) + 1)
        shape = extent + list(vals.shape[1:])
    if not stop_gradient:
        vals.stop_gradient = False
    return SparseCooTensor(idx, vals, shape)


def sparse_csr_tensor(crows, cols, values, shape, dtype=None,
                      stop_gradient=True) -> SparseCsrTensor:
    vals = ensure_tensor(values)
    if dtype is not None:
        vals = vals.astype(dtype)
    if not stop_gradient:
        vals.stop_gradient = False
    return SparseCsrTensor(crows, cols, vals, shape)


def is_same_shape(x, y) -> bool:
    return list(x.shape) == list(y.shape)


def _rows_cols(x):
    """(rows, cols) int64 of a 2-D COO or CSR tensor, on its device."""
    if isinstance(x, SparseCsrTensor):
        return x._rows(), x.cols_._value.long()
    idx = x.indices_._value
    return idx[0].long(), idx[1].long()


# -- elementwise binary: the union of the two patterns --------------------------

def _binary(name, x: SparseCooTensor, y: SparseCooTensor, op):
    if not isinstance(x, SparseCooTensor) or not isinstance(y, SparseCooTensor):
        raise TypeError(f"sparse.{name} expects SparseCooTensor operands")
    if x.shape != y.shape:
        raise ValueError(f"sparse.{name}: shape mismatch {x.shape} vs {y.shape}")
    dims = x._sparse_dims()
    kx = _keys.linearize(x.indices_._value, dims)
    ky = _keys.linearize(y.indices_._value, dims)
    uniq, inv = _keys.counted_unique(torch.cat([kx, ky]), return_inverse=True)
    ix, iy = inv[:kx.numel()], inv[kx.numel():]
    m = int(uniq.numel())

    def f(a, b):
        za = torch.zeros((m,) + tuple(a.shape[1:]), dtype=a.dtype,
                         device=a.device).index_add(0, ix, a)
        zb = torch.zeros((m,) + tuple(b.shape[1:]), dtype=b.dtype,
                         device=b.device).index_add(0, iy, b)
        return op(za, zb)
    vals = forward_op(f"sparse_{name}", f, [x.values_, y.values_])
    return SparseCooTensor(_wrap(_keys.unravel(uniq, dims)), vals, x.shape,
                           coalesced=True)


def add(x, y, name=None):
    return _binary("add", x, y, torch.add)


def subtract(x, y, name=None):
    return _binary("subtract", x, y, torch.sub)


def multiply(x, y, name=None):
    return _binary("multiply", x, y, torch.mul)


def matmul(x, y, name=None):
    """sparse @ dense -> dense: for a 2-D sparse ``x`` and a 2-D ``y``, the
    rows of ``y`` at the stored columns, scaled by the values and summed
    into their rows (``[nnz, n]`` work); otherwise through the dense
    product, as the reference."""
    if isinstance(x, (SparseCooTensor, SparseCsrTensor)) and \
            len(x.shape) == 2 and not isinstance(
                y, (SparseCooTensor, SparseCsrTensor)) and \
            x.values_.ndim == 1 and ensure_tensor(y).ndim == 2:
        rows, cols = _rows_cols(x)
        m = x.shape[0]

        def f(v, yy):
            contrib = v[:, None] * yy[cols]
            return torch.zeros((m, yy.shape[1]), dtype=contrib.dtype,
                               device=contrib.device).index_add(0, rows,
                                                                contrib)
        return forward_op("sparse_matmul", f, [x.values_, ensure_tensor(y)])
    xd = x.to_dense() if isinstance(x, (SparseCooTensor, SparseCsrTensor)) \
        else ensure_tensor(x)
    if isinstance(y, (SparseCooTensor, SparseCsrTensor)):
        y = y.to_dense()
    from ..ops.linalg import matmul as dense_matmul
    return dense_matmul(xd, ensure_tensor(y))


def masked_matmul(x, y, mask, name=None):
    """``(x @ y)`` at ``mask``'s pattern (SDDMM): one dot product a stored
    entry, in ``mask``'s format (COO or CSR)."""
    rows, cols = _rows_cols(mask)

    def f(a, b):
        return (a[rows] * b[:, cols].transpose(0, 1)).sum(-1)
    vals = forward_op("masked_matmul_sample", f,
                      [ensure_tensor(x), ensure_tensor(y)])
    if isinstance(mask, SparseCsrTensor):
        return SparseCsrTensor(mask.crows_, mask.cols_, vals, mask.shape)
    return SparseCooTensor(mask.indices_, vals, mask.shape)


def relu(x, name=None):
    return _values_map(x, "sparse_relu", torch.relu)


# -- the zero-preserving unary family (values-only work) -----------------------

def _values_map(x, name, tfn):
    if isinstance(x, SparseCsrTensor):
        vals = forward_op(name, tfn, [x.values_])
        return SparseCsrTensor(x.crows_, x.cols_, vals, x.shape)
    if not isinstance(x, SparseCooTensor):
        raise TypeError(f"sparse.{name.split('_', 1)[1]} expects a sparse "
                        f"tensor")
    vals = forward_op(name, tfn, [x.values_])
    return SparseCooTensor(x.indices_, vals, x.shape, x._coalesced)


def _sparse_unary(name, tfn):
    opname = f"sparse_{name}"

    def op(x, name=None):
        return _values_map(x, opname, tfn)
    op.__name__ = opname
    register_op(opname, tfn, f"sparse.{name}: zero-preserving elementwise "
                f"{name} on the values array.", public=op)
    return op


sin = _sparse_unary("sin", torch.sin)
tan = _sparse_unary("tan", torch.tan)
asin = _sparse_unary("asin", torch.asin)
atan = _sparse_unary("atan", torch.atan)
sinh = _sparse_unary("sinh", torch.sinh)
tanh = _sparse_unary("tanh", torch.tanh)
asinh = _sparse_unary("asinh", torch.asinh)
atanh = _sparse_unary("atanh", torch.atanh)
sqrt = _sparse_unary("sqrt", torch.sqrt)
square = _sparse_unary("square", torch.square)
log1p = _sparse_unary("log1p", torch.log1p)
abs = _sparse_unary("abs", torch.abs)  # noqa: A001
expm1 = _sparse_unary("expm1", torch.expm1)
deg2rad = _sparse_unary("deg2rad", torch.deg2rad)
rad2deg = _sparse_unary("rad2deg", torch.rad2deg)
neg = _sparse_unary("neg", torch.neg)


def pow(x, factor, name=None):  # noqa: A001
    """Elementwise power of the values (factor > 0 keeps zeros zero)."""
    return _values_map(x, "sparse_pow", lambda v: torch.pow(v, factor))


def cast(x, index_dtype=None, value_dtype=None, name=None):
    """Retype the indices and/or the values."""
    vals = x.values_ if value_dtype is None else x.values_.astype(value_dtype)
    if isinstance(x, SparseCsrTensor):
        crows = x.crows_ if index_dtype is None else \
            x.crows_.astype(index_dtype)
        cols = x.cols_ if index_dtype is None else x.cols_.astype(index_dtype)
        return SparseCsrTensor(crows, cols, vals, x.shape)
    idx = x.indices_ if index_dtype is None else \
        x.indices_.astype(index_dtype)
    return SparseCooTensor(idx, vals, x.shape, x._coalesced)


def divide(x, y, name=None):
    """Elementwise divide of two COO tensors with the SAME pattern (0/0 is
    undefined outside it); the pattern check reads one bool (counted)."""
    if not isinstance(x, SparseCooTensor) or not isinstance(y, SparseCooTensor):
        raise TypeError("sparse.divide expects SparseCooTensor operands")
    xc, yc = x.coalesce(), y.coalesce()
    same = xc.shape == yc.shape and xc.nnz() == yc.nnz() and \
        _keys.host_equal(xc.indices_._value, yc.indices_._value)
    if not same:
        raise ValueError(
            "sparse.divide requires operands with the same sparsity "
            "pattern (0/0 is undefined outside the intersection)")
    vals = forward_op("sparse_divide", lambda a, b: a / b,
                      [xc.values_, yc.values_])
    return SparseCooTensor(xc.indices_, vals, xc.shape, coalesced=True)


def mv(x, vec, name=None):
    """2-D sparse @ 1-D dense -> dense ``[m]``: the vector at the stored
    columns, scaled by the values, summed by row."""
    if not isinstance(x, (SparseCooTensor, SparseCsrTensor)) or \
            len(x.shape) != 2:
        raise TypeError("sparse.mv expects a 2-D sparse tensor")
    rows, cols = _rows_cols(x)
    m = x.shape[0]

    def f(vals, vv):
        contrib = vals * vv[cols]
        return torch.zeros(m, dtype=contrib.dtype,
                           device=contrib.device).index_add(0, rows, contrib)
    return forward_op("sparse_mv", f, [x.values_, ensure_tensor(vec)])


def addmm(input, x, y, beta: float = 1.0, alpha: float = 1.0, name=None):  # noqa: A002
    """``beta * input + alpha * (x @ y)``."""
    return ensure_tensor(input) * beta + matmul(x, y) * alpha


def sum(x, axis=None, dtype=None, keepdim: bool = False, name=None):  # noqa: A001
    """The sum of the values (``axis=None``), else through the dense
    tensor, as the reference."""
    if axis is None:
        out = forward_op("sparse_sum", lambda v: torch.sum(v), [x.values_])
        return out.astype(dtype) if dtype else out
    from ..ops import math as _m
    return _m.sum(x.to_dense(), axis=axis, keepdim=keepdim, dtype=dtype)


def transpose(x, perm, name=None):
    """Permute a COO tensor's dims: a permutation of the index rows."""
    if isinstance(x, SparseCsrTensor):
        x = x.to_sparse_coo()
    perm = [int(p) for p in perm]
    idx = forward_op("sparse_transpose", lambda i: i[perm], [x.indices_],
                     differentiable=False)
    return SparseCooTensor(idx, x.values_, [x.shape[p] for p in perm])


def reshape(x, shape, name=None):
    """COO reshape by the int64 linear index, on the device."""
    if isinstance(x, SparseCsrTensor):
        x = x.to_sparse_coo()
    old = x.shape
    total = int(np.prod(old))
    shape = [int(s) for s in shape]
    if -1 in shape:
        rest = int(np.prod([s for s in shape if s != -1]))
        shape = [s if s != -1 else total // rest for s in shape]
    lin = _keys.linearize(x.indices_._value, old)
    return SparseCooTensor(_wrap(_keys.unravel(lin, shape)), x.values_,
                           shape)


def coalesce(x, name=None):
    return x.coalesce()


def _sparse_softmax(x, axis: int = -1, name=None):
    """Row-wise softmax over the stored values (2-D patterns, last axis,
    as the reference's CSR kernel)."""
    if isinstance(x, SparseCsrTensor):
        coo, back = x.to_sparse_coo(), "csr"
    else:
        coo, back = x, "coo"
    if coo.ndim != 2 or axis not in (-1, 1):
        raise ValueError("sparse softmax supports 2-D patterns over the "
                         "last axis")
    m = coo.shape[0]
    row = coo.indices_._value[0].long()

    def f(vals):
        vmax = torch.zeros(m, dtype=vals.dtype, device=vals.device) \
            .scatter_reduce(0, row, vals.detach(), "amax", include_self=False)
        e = torch.exp(vals - vmax[row])
        den = torch.zeros(m, dtype=e.dtype, device=e.device).index_add(
            0, row, e)
        return e / den[row]

    vals = forward_op("sparse_softmax", f, [coo.values_])
    out = SparseCooTensor(coo.indices_, vals, coo.shape, coo._coalesced)
    return out.to_sparse_csr() if back == "csr" else out


def _relu6(x, name=None):
    return _values_map(x, "sparse_relu6", lambda v: torch.clamp(v, 0, 6))


def _leaky_relu(x, negative_slope: float = 0.01, name=None):
    return _values_map(x, "sparse_leaky_relu",
                       lambda v: torch.where(v >= 0, v, v * negative_slope))


def _dense_mask(sparse_mask, B, H, S):
    """The boolean pattern of ``attention``'s mask, built on the device and
    cached on the mask object: ``[B, H, S, S]`` for a ``[B*H, S, S]``
    CSR, ``[1, 1, S, S]`` for ``[S, S]``; a dense mask is its nonzeros."""
    if not isinstance(sparse_mask, SparseCsrTensor):
        m = ensure_tensor(sparse_mask)._value != 0
        return m[None, None] if m.dim() == 2 else m
    cached = getattr(sparse_mask, "_dense_mask_cache", None)
    if cached is not None and tuple(cached.shape[-2:]) == (S, S):
        return cached
    n = sparse_mask.shape[0] if len(sparse_mask.shape) == 3 else 1
    m = _keys.csr_pattern(sparse_mask.crows_._value,
                          sparse_mask.cols_._value, n, S, S)
    mask = m.reshape(B, H, S, S) if n > 1 else m[None]
    sparse_mask._dense_mask_cache = mask
    return mask


def attention(query, key, value, sparse_mask, key_padding_mask=None,
              attn_mask=None, name=None):
    """Attention over ``[B, H, S, D]`` where only the entries of the CSR
    ``sparse_mask`` pattern (``[B*H, S, S]`` or ``[S, S]``) take part in
    the softmax; ``key_padding_mask [B, S]`` and ``attn_mask`` (nonzero =
    keep) narrow it further; a row with no entry left gives zeros. The
    plain formula in fp32 scores, as the reference."""
    q, k, v = ensure_tensor(query), ensure_tensor(key), ensure_tensor(value)
    B, H, S, D = q.shape
    mask = _dense_mask(sparse_mask, B, H, S)
    extra = []
    if key_padding_mask is not None:
        extra.append(ensure_tensor(key_padding_mask))
    if attn_mask is not None:
        extra.append(ensure_tensor(attn_mask))

    def impl(qv, kv, vv, *ms):
        s = torch.einsum("bhqd,bhkd->bhqk", qv.float(), kv.float()) / \
            _math.sqrt(D)
        mm = mask
        i = 0
        if key_padding_mask is not None:
            mm = mm & (ms[i] != 0)[:, None, None, :]
            i += 1
        if attn_mask is not None:
            mm = mm & (ms[i] != 0)
        s = torch.where(mm, s, torch.full((), -1e30, device=s.device))
        p = torch.softmax(s, dim=-1)
        p = torch.where(mm.any(-1, keepdim=True), p,
                        torch.zeros((), device=p.device))
        return torch.einsum("bhqk,bhkd->bhqd", p.to(vv.dtype), vv)

    return forward_op("sparse_attention", impl, [q, k, v] + extra)


class nn:  # namespace parity: paddle.sparse.nn.ReLU / functional
    class ReLU(Layer):
        def forward(self, x):
            return relu(x)

    class Softmax(Layer):
        def __init__(self, axis: int = -1):
            super().__init__()
            self.axis = axis

        def forward(self, x):
            return _sparse_softmax(x, self.axis)

    class functional:
        relu = staticmethod(lambda x, name=None: relu(x))
        softmax = staticmethod(_sparse_softmax)
        relu6 = staticmethod(_relu6)
        leaky_relu = staticmethod(_leaky_relu)
        attention = staticmethod(attention)


# the registry, under the reference's names (the unary family registers in
# _sparse_unary); ``public`` is the user-facing call
for _n, _f, _p, _d in [
    ("sparse_pow", lambda v: v, pow, "values power (zero-preserving)"),
    ("sparse_cast", lambda v: v, cast, "retype indices/values"),
    ("sparse_divide", torch.div, divide, "elementwise divide"),
    ("sparse_mv", lambda i, v, x: v, mv, "sparse matrix-vector product"),
    ("sparse_addmm", lambda a, b: a, addmm, "beta*input + alpha*(x@y)"),
    ("sparse_sum", torch.sum, sum, "sum of values"),
    ("sparse_transpose", lambda i: i, transpose,
     "dim permutation on indices"),
    ("sparse_reshape", lambda i: i, reshape, "linear-index reshape"),
    ("sparse_matmul", torch.matmul, matmul, "sparse @ dense"),
    ("sparse_masked_matmul", torch.matmul, masked_matmul, "sddmm sampling"),
    ("sparse_add", torch.add, add, "elementwise add"),
    ("sparse_subtract", torch.sub, subtract, "elementwise subtract"),
    ("sparse_multiply", torch.mul, multiply, "elementwise multiply"),
    ("sparse_relu", torch.relu, relu, "relu on values"),
    ("sparse_coalesce", lambda v: v, coalesce,
     "merge duplicate coordinates"),
    ("sparse_softmax", lambda i, v: v, _sparse_softmax,
     "row-wise softmax over stored values"),
    ("sparse_relu6", lambda v: torch.clamp(v, 0, 6), _relu6,
     "relu6 on values"),
    ("sparse_leaky_relu", lambda v: v, _leaky_relu, "leaky_relu on values"),
]:
    register_op(_n, _f, f"sparse.{_n.split('_', 1)[1]}: {_d}", public=_p)

__all__ += ["attention"]

# the sparse convolution family extends sparse.nn
from . import nn_conv as _nn_conv  # noqa: E402
nn.Conv3D = _nn_conv.Conv3D
nn.SubmConv3D = _nn_conv.SubmConv3D
nn.BatchNorm = _nn_conv.BatchNorm
nn.MaxPool3D = _nn_conv.MaxPool3D
nn.functional.conv3d = staticmethod(_nn_conv.conv3d)
nn.functional.subm_conv3d = staticmethod(_nn_conv.subm_conv3d)
nn.functional.max_pool3d = staticmethod(_nn_conv.max_pool3d)
nn.functional.batch_norm = staticmethod(_nn_conv.batch_norm)
__all__ += ["nn_conv"]
