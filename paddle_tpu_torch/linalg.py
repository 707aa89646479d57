"""``paddle.linalg`` namespace — counterpart of ``paddle_tpu/linalg.py``."""

from .ops.linalg import (lu, lu_unpack, matrix_exp, ormqr,  # noqa: F401
                         svd_lowrank, bmm, cholesky, cholesky_solve, cond,
                         corrcoef, cov, det, dist, eig, eigh, eigvals,
                         eigvalsh, einsum, householder_product, inv, lstsq,
                         matmul, matrix_norm, matrix_power, matrix_rank,
                         multi_dot, mv, norm, pinv, qr, slogdet, solve, svd,
                         svdvals, t, triangular_solve, vector_norm)
from .ops.math import cross, dot  # noqa: F401

__all__ = [
    "bmm", "cholesky", "cholesky_solve", "cond", "corrcoef", "cov", "det", "dist",
    "eig", "eigh", "eigvals", "eigvalsh", "einsum", "householder_product", "inv",
    "lstsq", "matmul", "matrix_norm", "matrix_power", "matrix_rank", "multi_dot",
    "mv", "norm", "pinv", "qr", "slogdet", "solve", "svd", "svdvals", "t",
    "triangular_solve", "vector_norm", "cross", "dot", "lu",
    "lu_unpack", "matrix_exp", "ormqr", "svd_lowrank",
]
