"""Linear algebra ops — counterpart of ``paddle_tpu/ops/linalg.py``: the
matmul family, norms, and the decompositions and solvers over
``torch.linalg`` (cuSOLVER / cuBLAS on the card), on the tensor's device.

Where the reference leaves XLA: ``eig`` / ``eigvals`` (host numpy there)
are ``torch.linalg.eig`` here, complex as torch gives them; ``lstsq``
keeps the reference's contract, JAX's SVD-based minimum-norm solve with
``(solution, residuals, rank, singular_values)``, computed from
``torch.linalg.svd`` on both devices (CUDA's ``torch.linalg.lstsq`` has
only the full-rank ``gels`` driver); ``svd_lowrank`` draws its test matrix
from the port's per-device generator.
"""

from __future__ import annotations

import torch

from ..core.tensor import Tensor
from ._helpers import (axes_arg, ensure_tensor, forward_op,
                       patch_methods, register_op)
from .random import generator


def matmul(x, y, transpose_x=False, transpose_y=False, name=None) -> Tensor:
    x, y = ensure_tensor(x), ensure_tensor(y)

    def impl(a, b):
        if transpose_x and a.dim() >= 2:
            a = a.transpose(-1, -2)
        if transpose_y and b.dim() >= 2:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)

    return forward_op("matmul", impl, [x, y])


def mm(input, mat2, name=None) -> Tensor:  # noqa: A002
    return matmul(input, mat2)


def bmm(x, y, name=None) -> Tensor:
    return matmul(x, y)


def mv(x, vec, name=None) -> Tensor:
    return matmul(x, vec)


def t(input, name=None) -> Tensor:  # noqa: A002
    input = ensure_tensor(input)
    if input.ndim > 2:
        raise ValueError("paddle.t only supports ndim<=2")
    return forward_op("t", lambda v: v.T, [input])


def norm(x, p=None, axis=None, keepdim=False, name=None) -> Tensor:
    x = ensure_tensor(x)
    ax = axes_arg(axis)
    if p is None:
        p = "fro" if (ax is None or isinstance(ax, tuple)) else 2

    def impl(v):
        if ax is None:
            flat = v.reshape(-1)
            if p in ("fro", 2):
                return torch.linalg.vector_norm(flat)
            return torch.linalg.vector_norm(flat, ord=p)
        if isinstance(ax, tuple) and len(ax) == 2:
            return torch.linalg.matrix_norm(v, ord=p, dim=ax, keepdim=keepdim)
        return torch.linalg.vector_norm(v, ord=2 if p == "fro" else p, dim=ax,
                                        keepdim=keepdim)

    return forward_op("norm", impl, [x])


def einsum(equation, *operands) -> Tensor:
    ts = [ensure_tensor(o) for o in operands]
    return forward_op("einsum", lambda *vs: torch.einsum(equation, *vs), ts)




def vector_norm(x, p=2, axis=None, keepdim=False, name=None) -> Tensor:
    ax = axes_arg(axis)
    return forward_op("vector_norm",
                      lambda v: torch.linalg.vector_norm(
                          v, ord=p, dim=ax, keepdim=keepdim),
                      [ensure_tensor(x)])


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None) -> Tensor:
    return forward_op("matrix_norm",
                      lambda v: torch.linalg.matrix_norm(
                          v, ord=p, dim=tuple(axis), keepdim=keepdim),
                      [ensure_tensor(x)])


def dist(x, y, p=2, name=None) -> Tensor:
    return norm(ensure_tensor(x) - ensure_tensor(y), p=p)


def cholesky(x, upper=False, name=None) -> Tensor:
    return forward_op("cholesky",
                      lambda v: torch.linalg.cholesky(v, upper=upper),
                      [ensure_tensor(x)])


def _vec_rhs(solve):
    """``solve(A, B)`` that also takes a vector ``B``, as the reference's
    triangular solves do."""
    def f(a, b, *rest):
        if b.dim() == 1:
            return solve(a, b[:, None], *rest)[:, 0]
        return solve(a, b, *rest)
    return f


def _cho_solve(u, b, upper):
    """``A^-1 b`` for ``A = L L^T`` with ``L`` the lower triangle of ``u``
    (of ``u^T`` when ``upper``): two triangular solves, as the reference's
    ``cho_solve``, so the gradient reaches that triangle only."""
    low = u.mT if upper else u
    z = torch.linalg.solve_triangular(low, b, upper=False)
    return torch.linalg.solve_triangular(low.mT, z, upper=True)


def cholesky_solve(x, y, upper=False, name=None) -> Tensor:
    return forward_op("cholesky_solve",
                      _vec_rhs(lambda u, b: _cho_solve(u, b, upper)),
                      [ensure_tensor(y), ensure_tensor(x)])


def qr(x, mode="reduced", name=None):
    def impl(v):
        q, r = torch.linalg.qr(v, mode=mode)
        return r if mode == "r" else (q, r)
    return forward_op("qr", impl, [ensure_tensor(x)])


def svd(x, full_matrices=False, name=None):
    return forward_op("svd", lambda v: tuple(torch.linalg.svd(
        v, full_matrices=full_matrices)), [ensure_tensor(x)])


def svdvals(x, name=None) -> Tensor:
    return forward_op("svdvals", torch.linalg.svdvals, [ensure_tensor(x)])


def eig(x, name=None):
    """General eigendecomposition ``(w, v)`` (complex), on the tensor's
    device; eigenvalue order and eigenvector phase are not unique."""
    return forward_op("eig", lambda v: tuple(torch.linalg.eig(v)),
                      [ensure_tensor(x)], differentiable=False)


def eigh(x, UPLO="L", name=None):
    return forward_op("eigh", lambda v: tuple(torch.linalg.eigh(v, UPLO=UPLO)),
                      [ensure_tensor(x)])


def eigvals(x, name=None) -> Tensor:
    return forward_op("eigvals", torch.linalg.eigvals, [ensure_tensor(x)],
                      differentiable=False)


def eigvalsh(x, UPLO="L", name=None) -> Tensor:
    return forward_op("eigvalsh",
                      lambda v: torch.linalg.eigvalsh(v, UPLO=UPLO),
                      [ensure_tensor(x)])


def inv(x, name=None) -> Tensor:
    return forward_op("inv", torch.linalg.inv, [ensure_tensor(x)])


def pinv(x, rcond=1e-15, hermitian=False, name=None) -> Tensor:
    return forward_op("pinv", lambda v: torch.linalg.pinv(
        v, rtol=rcond, hermitian=hermitian), [ensure_tensor(x)])


def solve(x, y, name=None) -> Tensor:
    return forward_op("solve", torch.linalg.solve,
                      [ensure_tensor(x), ensure_tensor(y)])


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None) -> Tensor:
    def impl(a, b):
        if transpose:
            a, up = a.mT, not upper
        else:
            up = upper
        return torch.linalg.solve_triangular(a, b, upper=up,
                                             unitriangular=unitriangular)
    return forward_op("triangular_solve", _vec_rhs(impl),
                      [ensure_tensor(x), ensure_tensor(y)])


def _lstsq(a, b, rcond):
    """JAX's minimum-norm solve: singular values below ``rcond * s[0]``
    (``eps * max(m, n)`` by default) count as zero."""
    vec = b.dim() == 1
    if vec:
        b = b[:, None]
    m, n = a.shape
    if rcond is None:
        rcond = torch.finfo(a.dtype).eps * max(m, n)
    elif rcond < 0:
        rcond = torch.finfo(a.dtype).eps
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    mask = (s > 0) & (s >= rcond * s[0])
    rank = mask.sum()
    s_inv = torch.where(mask, 1 / torch.where(mask, s, torch.ones_like(s)),
                        torch.zeros_like(s))[:, None]
    sol = vt.mT @ (s_inv * (u.mT @ b))
    resid = torch.linalg.vector_norm(b - a @ sol, dim=0) ** 2
    return (sol.reshape(-1) if vec else sol), resid, rank, s


def lstsq(x, y, rcond=None, driver=None, name=None):
    """``(solution, residuals, rank, singular_values)`` of the minimum-norm
    least-squares solve (the reference's contract: JAX's SVD route, on any
    rank; residuals always returned)."""
    return forward_op("lstsq", lambda a, b: _lstsq(a, b, rcond),
                      [ensure_tensor(x), ensure_tensor(y)],
                      differentiable=False)


def det(x, name=None) -> Tensor:
    return forward_op("det", torch.linalg.det, [ensure_tensor(x)])


def slogdet(x, name=None):
    return forward_op("slogdet", lambda v: tuple(torch.linalg.slogdet(v)),
                      [ensure_tensor(x)])


def matrix_power(x, n, name=None) -> Tensor:
    return forward_op("matrix_power",
                      lambda v: torch.linalg.matrix_power(v, int(n)),
                      [ensure_tensor(x)])


def matrix_rank(x, tol=None, hermitian=False, name=None) -> Tensor:
    return forward_op("matrix_rank",
                      lambda v: torch.linalg.matrix_rank(v, rtol=tol),
                      [ensure_tensor(x)], differentiable=False)


def _cond(v, p):
    """The condition number as ``jnp.linalg.cond`` computes it: the ratio
    of extreme singular values for p in (None, 2, -2), else ``norm(A, p)
    * norm(inv(A), p)`` (``torch.linalg.cond`` has no gradient there)."""
    if p in (None, 2, -2):
        s = torch.linalg.svdvals(v)
        hi, lo = s[..., 0], s[..., -1]
        return hi / lo if p != -2 else lo / hi
    return torch.linalg.matrix_norm(v, ord=p) * torch.linalg.matrix_norm(
        torch.linalg.inv(v), ord=p)


def cond(x, p=None, name=None) -> Tensor:
    return forward_op("cond_number", lambda v: _cond(v, p),
                      [ensure_tensor(x)])


def multi_dot(tensors, name=None) -> Tensor:
    ts = [ensure_tensor(t) for t in tensors]
    return forward_op("multi_dot",
                      lambda *vs: torch.linalg.multi_dot(list(vs)), ts)


def householder_product(x, tau, name=None) -> Tensor:
    return forward_op("householder_product", torch.linalg.householder_product,
                      [ensure_tensor(x), ensure_tensor(tau)])


def corrcoef(x, rowvar=True, name=None) -> Tensor:
    return forward_op("corrcoef",
                      lambda v: torch.corrcoef(v if rowvar else v.mT),
                      [ensure_tensor(x)])


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None,
        name=None) -> Tensor:
    return forward_op("cov", lambda v: torch.cov(
        v if rowvar else v.mT, correction=1 if ddof else 0),
        [ensure_tensor(x)])


patch_methods([
    ("matmul", matmul), ("mm", mm), ("bmm", bmm), ("mv", mv), ("t", t),
    ("norm", norm), ("cholesky", cholesky), ("inv", inv), ("pinv", pinv),
    ("det", det), ("matrix_power", matrix_power),
])


def lu(x, pivot=True, get_infos=False, name=None):
    """LU factorization (ref: paddle.linalg.lu — packed LU + 1-based int32
    pivots [+ infos])."""
    t = ensure_tensor(x)
    lu_mat, pivots = forward_op(
        "lu", lambda v: tuple(torch.linalg.lu_factor(v, pivot=pivot)), [t])
    if get_infos:
        from .creation import zeros
        return lu_mat, pivots, zeros(list(t.shape[:-2]) or [1], "int32")
    return lu_mat, pivots


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """Unpack packed LU + pivots into (P, L, U) with A = P L U."""
    return forward_op("lu_unpack",
                      lambda a, p: tuple(torch.lu_unpack(a, p.to(torch.int32))),
                      [ensure_tensor(x), ensure_tensor(y)])


def matrix_exp(x, name=None):
    """Matrix exponential (ref: paddle.linalg.matrix_exp)."""
    return forward_op("matrix_exp", torch.linalg.matrix_exp,
                      [ensure_tensor(x)])


def ormqr(x, tau, other, left=True, transpose=False, name=None):
    """Multiply by the FULL m x m Q of a Householder QR factorization: the
    k reflectors in ``x``'s lower trapezoid are applied to ``other`` one
    rank-1 update at a time (ref: paddle.linalg.ormqr / LAPACK ormqr)."""
    a, tt, c = ensure_tensor(x), ensure_tensor(tau), ensure_tensor(other)
    if a.ndim != 2 or c.ndim != 2:
        raise ValueError("ormqr: batched inputs are not supported; got "
                         f"ndim {a.ndim}/{c.ndim}")

    def f(av, tv, cv):
        m, k = av.shape[0], tv.shape[0]
        rows = torch.arange(m, device=av.device)

        def reflect(i, mat):
            v = torch.where(rows > i, av[:, i],
                            (rows == i).to(av.dtype))
            return mat - tv[i] * torch.outer(v, v @ mat)

        def apply_q(mat, trans):
            # Q = H_0 H_1 ... H_{k-1}: Q @ C applies the reflectors right
            # to left, Q^T @ C left to right
            for j in range(k):
                mat = reflect(j if trans else k - 1 - j, mat)
            return mat

        if left:
            return apply_q(cv, transpose)
        return apply_q(cv.mT, not transpose).mT
    return forward_op("ormqr", f, [a, tt, c])


def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    """Randomized low-rank SVD (ref: paddle.linalg.svd_lowrank; Halko et al.
    subspace iteration). Returns (U [m,q], S [q], V [n,q])."""
    t = ensure_tensor(x)
    m, n = t.shape[-2], t.shape[-1]
    q = min(q, m, n)

    def f(v, mv=None):
        a = v if mv is None else v - mv
        omega = torch.randn(a.shape[:-2] + (n, q), dtype=a.dtype,
                            device=a.device, generator=generator(a.device))
        y = a @ omega
        for _ in range(niter):
            y = a @ (a.mT @ y)
        qmat, _ = torch.linalg.qr(y)
        ub, s, vt = torch.linalg.svd(qmat.mT @ a, full_matrices=False)
        return qmat @ ub, s, vt.mT
    args = [t] if M is None else [t, ensure_tensor(M)]
    return forward_op("svd_lowrank", f, args)


def cholesky_inverse(x, upper: bool = False, name=None) -> Tensor:
    """Inverse of a matrix given its Cholesky factor: A^-1 from u with
    A = u u^T (lower) / u^T u (upper)."""
    return forward_op("cholesky_inverse", lambda u: _cho_solve(
        u, torch.eye(u.shape[-1], dtype=u.dtype, device=u.device), upper),
        [ensure_tensor(x)])


def lu_solve(b, lu_data, pivots, trans: int = 0, name=None) -> Tensor:
    """Solve A x = b (A^T x = b for ``trans`` 1 or 2) from the packed LU
    factorization; ``pivots`` are 1-based (paddle/LAPACK)."""
    return forward_op(
        "lu_solve",
        _vec_rhs(lambda luv, bv, pv: torch.linalg.lu_solve(
            luv, pv.to(torch.int32), bv, adjoint=trans != 0)),
        [ensure_tensor(lu_data), ensure_tensor(b), ensure_tensor(pivots)])


def tensorinv(x, ind: int = 2, name=None) -> Tensor:
    """Inverse of a tensor viewed as a linear map (numpy.linalg.tensorinv)."""
    return forward_op("tensorinv",
                      lambda v: torch.linalg.tensorinv(v, ind=ind),
                      [ensure_tensor(x)])


def tensorsolve(x, y, axes=None, name=None) -> Tensor:
    """Solve the tensor equation a x = b (numpy.linalg.tensorsolve)."""
    return forward_op("tensorsolve",
                      lambda a, b: torch.linalg.tensorsolve(a, b, dims=axes),
                      [ensure_tensor(x), ensure_tensor(y)])


def geqrf(x, name=None):
    """Raw QR factorization (LAPACK geqrf: packed householder + tau)."""
    return forward_op("geqrf", lambda v: tuple(torch.geqrf(v)),
                      [ensure_tensor(x)])


orgqr = householder_product  # LAPACK name alias (torch.orgqr parity)

for _n, _f in (("cholesky_inverse", cholesky_inverse), ("lu_solve", lu_solve),
               ("tensorinv", tensorinv), ("tensorsolve", tensorsolve),
               ("geqrf", geqrf), ("orgqr", orgqr)):
    register_op(_n, _f, (_f.__doc__ or "").strip().split("\n")[0], public=_f)
