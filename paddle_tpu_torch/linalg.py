"""paddle.linalg of the port (counterpart of paddle_tpu/linalg.py): the
implementations live in ops/linalg.py and dispatch through the op
layer."""
from .ops.linalg import (bmm, cholesky, cross, det, dist, dot, eigh, inner,
                         inverse, kron, matmul, matrix_power, mm, mv, norm,
                         outer, pinv, qr, slogdet, solve, svd, t, trace,
                         triangular_solve)

__all__ = ["matmul", "mm", "bmm", "dot", "outer", "inner", "t", "norm",
           "dist", "cross", "cholesky", "inverse", "pinv", "solve",
           "triangular_solve", "svd", "qr", "eigh", "det", "slogdet",
           "matrix_power", "trace", "kron", "mv"]
