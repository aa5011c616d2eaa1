"""The paddle API's op cases: the arguments of every op of the eight modules
ported from `paddle_tpu/ops` (activation, creation, linalg, manipulation,
math, nn_ops, random_ops, reduction) at tiny shapes, made from a seed of
the op's name.

`tests/test_torch_ops_api.py` holds each op on the CPU to the JAX
package's; phase `paddle_api` of `chip_smoke.py` holds the same ops on the
card to the CPU. Imports numpy only.
"""
import numpy as np


class OpCase:
    """One op's case: its argument specs, its keyword arguments, whether
    it is differentiable, its tolerance, whether it draws (seeded first)
    and `check="shape"` where only dtype and shape compare."""

    def __init__(self, *args, grad=False, tol=1e-6, rand=False, check=None,
                 **kw):
        # check: None compares every output; "shape" dtypes and shapes;
        # "decomp" the unique parts (values) and the reconstruction of a
        # decomposition whose vectors' signs are LAPACK's choice
        self.args, self.kw, self.grad, self.tol = args, kw, grad, tol
        self.rand, self.check = rand, check


# argument specs: ("f", shape[, scale]) normal f32, ("p", shape[, lo]) in
# (lo, lo + 1.5), ("u", shape) in (-0.9, 0.9), ("q", shape) in (0.05,
# 0.95), ("s", shape) sorted normal, ("n", shape) normal with a NaN and an
# inf, ("i", shape, lo, hi) int32 (the "int64" name), ("b", shape) bool,
# ("c", shape) complex64, ("perm", k, n) k distinct int32 in [0, n), ("L",
# [specs]) a list of tensors, ("spd", n) a symmetric positive definite
# n x n, ("w", n) a well-conditioned n x n, ("tri", n) an upper triangular
# n x n with a dominant diagonal, ("pm", shape) +-1 floats; anything else
# passes as is
_F34, _P34, _U34 = ("f", (3, 4)), ("p", (3, 4)), ("u", (3, 4))
_I34 = ("i", (3, 4), -5, 6)
_LOOSE = 1e-5           # transcendental and special functions
C = OpCase
PADDLE_OP_CASES = {
    # activation
    "celu": C(_F34, grad=True, alpha=1.3),
    "elu": C(_F34, grad=True, alpha=0.7),
    "gelu": C(_F34, grad=True),
    "glu": C(("f", (3, 6)), grad=True, axis=-1),
    "gumbel_softmax": C(_F34, rand=True, grad=True, temperature=0.5),
    "hardshrink": C(_F34, grad=True, threshold=0.4),
    "hardsigmoid": C(_F34, grad=True),
    "hardswish": C(_F34, grad=True),
    "hardtanh": C(_F34, grad=True, min=-0.5, max=0.7),
    "leaky_relu": C(_F34, grad=True, negative_slope=0.2),
    "log_sigmoid": C(_F34, grad=True),
    "log_softmax": C(_F34, grad=True, axis=0),
    "maxout": C(("f", (2, 6, 3)), 3, grad=True),
    "mish": C(_F34, grad=True),
    "prelu": C(("f", (2, 3, 4)), ("f", (3,)), grad=True),
    "relu": C(_F34, grad=True),
    "relu6": C(("f", (3, 4), 4.0), grad=True),
    "rrelu": C(_F34, rand=True, grad=True),
    "selu": C(_F34, grad=True),
    "sigmoid": C(_F34, grad=True),
    "silu": C(_F34, grad=True),
    "softmax": C(_F34, grad=True, axis=1),
    "softplus": C(("f", (3, 4), 10.0), grad=True, beta=2.0, threshold=15.0),
    "softshrink": C(_F34, grad=True, threshold=0.3),
    "softsign": C(_F34, grad=True),
    "swish": C(_F34, grad=True),
    "tanh": C(_F34, grad=True),
    "tanhshrink": C(_F34, grad=True),
    "thresholded_relu": C(_F34, grad=True, threshold=0.2),
    # creation
    "arange": C(2, 11, 3),
    "complex": C(_F34, _F34),
    "diag": C(("f", (4,)), 1),
    "diagflat": C(("f", (2, 2)), -1),
    "empty": C([2, 3], "int64"),
    "empty_like": C(_F34),
    "eye": C(3, 4, "float32"),
    "full": C([2, 3], 1.5),
    "full_like": C(_I34, 7),
    "linspace": C(-1.0, 2.5, 7),
    "logspace": C(0.0, 2.0, 5, base=3.0),
    "meshgrid": C(("f", (3,)), ("f", (2,))),
    "one_hot": C(("i", (5,), 0, 4), 4),
    "ones": C([3, 2], "bool"),
    "ones_like": C(_F34, "int32"),
    "to_tensor": C([[1, 2], [3, 4]], "float32"),
    "tril": C(_F34, -1, grad=True),
    "triu": C(_F34, 1, grad=True),
    "vander": C(("f", (4,)), 3, grad=True),
    "zeros": C([2, 2]),
    "zeros_like": C(_F34, "bool"),
    # manipulation
    "as_complex": C(("f", (3, 2))),
    "as_real": C(("c", (3,))),
    "as_strided": C(_F34, [2, 3], [4, 1], 1, grad=True),
    "broadcast_to": C(("f", (1, 4)), [3, 4], grad=True),
    "bucketize": C(("f", (5,)), ("s", (6,))),
    "chunk": C(("f", (4, 3)), 2, grad=True),
    "clone": C(_F34, grad=True),
    "concat": C(("L", [_F34, ("f", (2, 4))]), grad=True),
    "crop": C(("f", (4, 5)), [2, 3], [1, 2], grad=True),
    "diff": C(("f", (3, 5)), grad=True, prepend=0.5, append=1.5),
    "dsplit": C(("f", (2, 2, 4)), 2, grad=True),
    "expand": C(("f", (3, 1)), [2, 3, 4], grad=True),
    "expand_as": C(("f", (1, 4)), _F34, grad=True),
    "flatten": C(("f", (2, 3, 4)), 1, 2, grad=True),
    "flip": C(_F34, [0, 1], grad=True),
    "gather": C(_F34, ("i", (3,), 0, 4), 1, grad=True),
    "gather_nd": C(_F34, ("i", (2, 2), 0, 3), grad=True),
    "getitem": C(_F34, (slice(0, 2), 1), grad=True),
    "hsplit": C(("f", (2, 6)), [1, 4], grad=True),
    "index_select": C(_F34, ("i", (5,), 0, 3), grad=True),
    "masked_select": C(_F34, ("b", (3, 4))),
    "moveaxis": C(("f", (2, 3, 4)), 0, 2, grad=True),
    "numel": C(("f", (2, 3, 4))),
    "pad": C(("f", (1, 2, 3, 4)), [1, 2, 0, 1], grad=True, mode="reflect"),
    "put_along_axis": C(_F34, ("i", (3, 1), 0, 4), 9.0, 1, grad=True),
    "repeat_interleave": C(_F34, 2, grad=True, axis=0),
    "reshape": C(_F34, [2, -1], grad=True),
    "roll": C(_F34, 2, grad=True, axis=1),
    "rot90": C(_F34, 1, grad=True),
    "scatter": C(("f", (5, 3)), ("perm", 3, 5), ("f", (3, 3)), grad=True,
                 overwrite=False),
    "scatter_nd": C(("i", (4, 2), 0, 3), ("f", (4,)), [3, 3], grad=True),
    "searchsorted": C(("s", (6,)), ("f", (2, 3))),
    "slice": C(("f", (3, 5)), [1], [1], [4], grad=True),
    "split": C(("f", (6, 2)), [1, -1, 2], grad=True),
    "squeeze": C(("f", (3, 1, 4)), grad=True),
    "squeeze_": C(("f", (3, 1, 4)), 1, grad=True),
    "stack": C(("L", [_F34, _F34]), 1, grad=True),
    "strided_slice": C(("f", (6, 5)), [0, 1], [5, 0], [0, 5], [-2, 2],
                       grad=True),
    "swapaxes": C(("f", (2, 3, 4)), 0, 2, grad=True),
    "swapdims": C(("f", (2, 3, 4)), 1, 2, grad=True),
    "take": C(_F34, ("i", (2, 3), -12, 12), grad=True),
    "take_along_axis": C(_F34, ("i", (3, 2), 0, 4), 1, grad=True),
    "tensordot": C(("f", (2, 3, 4)), ("f", (3, 4, 5)), 2, grad=True),
    "tile": C(("f", (2, 3)), [2, 1, 2], grad=True),
    "transpose": C(("f", (2, 3, 4)), [2, 0, 1], grad=True),
    "unbind": C(_F34, 1, grad=True),
    "unsqueeze": C(_F34, [0, 3], grad=True),
    "unsqueeze_": C(_F34, -1, grad=True),
    "unstack": C(_F34, grad=True),
    "vsplit": C(("f", (4, 3)), 2, grad=True),
    # math
    "abs": C(_F34, grad=True),
    "acos": C(_U34, grad=True),
    "acosh": C(("p", (3, 4), 1.1), grad=True),
    "add": C(_F34, ("f", (4,)), grad=True),
    "addmm": C(("f", (3, 5)), ("f", (3, 4)), ("f", (4, 5)), grad=True,
               beta=0.5, alpha=2.0),
    "allclose": C(_F34, _F34),
    "angle": C(_F34),
    "asin": C(_U34, grad=True),
    "asinh": C(_F34, grad=True),
    "atan": C(_F34, grad=True),
    "atan2": C(_F34, _P34, grad=True),
    "atanh": C(_U34, grad=True),
    "bitwise_and": C(_I34, _I34),
    "bitwise_not": C(_I34),
    "bitwise_or": C(_I34, _I34),
    "bitwise_xor": C(_I34, _I34),
    "cast": C(_F34, "int32"),
    "ceil": C(_F34),
    "clip": C(_F34, -0.5, 0.8, grad=True),
    "conj": C(("c", (3,))),
    "copysign": C(_F34, _F34, grad=True),
    "cos": C(_F34, grad=True),
    "cosh": C(_F34, grad=True),
    "digamma": C(_P34, grad=True, tol=_LOOSE),
    "divide": C(_F34, _P34, grad=True),
    "equal": C(_I34, _I34),
    "equal_all": C(_I34, _I34),
    "erf": C(_F34, grad=True, tol=_LOOSE),
    "erfinv": C(_U34, grad=True, tol=_LOOSE),
    "exp": C(_F34, grad=True),
    "expm1": C(_F34, grad=True),
    "float_power": C(_P34, _F34, grad=True),
    "floor": C(_F34),
    "floor_divide": C(_I34, ("i", (3, 4), 1, 4)),
    "fmax": C(_F34, _F34, grad=True),
    "fmin": C(_F34, _F34, grad=True),
    "fmod": C(_F34, _P34, grad=True),
    "frac": C(("f", (3, 4), 3.0), grad=True),
    "greater_equal": C(_I34, _I34),
    "greater_than": C(_F34, _F34),
    "heaviside": C(_F34, _F34),
    "hypot": C(_F34, _F34, grad=True),
    "i0": C(_F34, grad=True, tol=_LOOSE),
    "imag": C(_F34, grad=True),
    "increment": C(_F34, 2.5),
    "isclose": C(_F34, _F34),
    "isfinite": C(_F34),
    "isinf": C(_F34),
    "isnan": C(_F34),
    "lerp": C(_F34, _F34, 0.3, grad=True),
    "less_equal": C(_F34, _F34),
    "less_than": C(_I34, _I34),
    "lgamma": C(_P34, grad=True, tol=_LOOSE),
    "log": C(_P34, grad=True),
    "log10": C(_P34, grad=True),
    "log1p": C(_P34, grad=True),
    "log2": C(_P34, grad=True),
    "logaddexp": C(_F34, _F34, grad=True),
    "logical_and": C(("b", (3, 4)), ("b", (3, 4))),
    "logical_not": C(("b", (3, 4))),
    "logical_or": C(("b", (3, 4)), ("b", (3, 4))),
    "logical_xor": C(_I34, _I34),
    "logit": C(("q", (3, 4)), grad=True, eps=0.1),
    "maximum": C(_F34, _F34, grad=True),
    "minimum": C(_F34, _F34, grad=True),
    "mod": C(_F34, _P34, grad=True),
    "multiplex": C(("L", [_F34, _F34]), ("i", (3, 1), 0, 2), grad=True),
    "multiply": C(_F34, 2.5, grad=True),
    "multiply_": C(_F34, _F34),
    "nan_to_num": C(("n", (3, 4)), grad=True, nan=1.5, posinf=9.0),
    "neg": C(_F34, grad=True),
    "nextafter": C(_F34, _F34),
    "not_equal": C(_I34, _I34),
    "polygamma": C(_P34, 1, grad=True, tol=_LOOSE),
    "pow": C(_P34, _F34, grad=True),
    "real": C(_F34, grad=True),
    "reciprocal": C(_P34, grad=True),
    "remainder": C(_F34, _P34, grad=True),
    "round": C(("f", (3, 4), 3.0)),
    "rsqrt": C(_P34, grad=True),
    "scale": C(_F34, 2.0, 0.5, grad=True, bias_after_scale=False),
    "sgn": C(_F34),
    "sign": C(_F34),
    "signbit": C(_F34),
    "sin": C(_F34, grad=True),
    "sinc": C(_F34, grad=True),
    "sinh": C(_F34, grad=True),
    "sqrt": C(_P34, grad=True),
    "square": C(_F34, grad=True),
    "stanh": C(_F34, grad=True),
    "subtract": C(_I34, 3),
    "tan": C(_U34, grad=True),
    "true_divide": C(_F34, _P34, grad=True),
    "trunc": C(("f", (3, 4), 3.0)),
    "where": C(("b", (3, 4)), _F34, _F34, grad=True),
    # random_ops
    "bernoulli": C(("q", (50,)), rand=True),
    "exponential": C(("f", (40,)), 2.0, rand=True),
    "multinomial": C(("p", (3, 6)), 4, rand=True, replacement=True),
    "normal": C(0.5, 2.0, [5, 7], rand=True),
    "normal_": C(("f", (30,)), 1.0, 3.0, rand=True),
    # jax's Poisson algorithm is not reproduced: held by its distribution
    # (tests/test_torch_core.py), here by dtype and shape
    "poisson": C(("p", (20,)), rand=True, check="shape"),
    "rand": C([4, 5], rand=True),
    "randint": C(-3, 9, [4, 6], rand=True),
    "randint_like": C(_I34, 0, 100, rand=True),
    "randn": C([64], rand=True),
    "randperm": C(10, rand=True),
    "shuffle": C(("f", (6, 2)), rand=True),
    "standard_normal": C([3, 5], rand=True),
    "uniform": C([4, 4], "float32", -2.0, 3.0, rand=True),
    "uniform_": C(("f", (20,)), -1.0, 0.5, rand=True),
    # reduction
    "all": C(("b", (3, 4)), 1),
    "amax": C(_F34, 0, True, grad=True),
    "amin": C(_F34, [0, 1], grad=True),
    "any": C(("b", (3, 4))),
    "argmax": C(_F34, 1),
    "argmin": C(_F34),
    "argsort": C(("i", (3, 6), 0, 3), 1, True),
    "bincount": C(("i", (9,), 0, 5), minlength=7),
    "count_nonzero": C(("i", (3, 4), 0, 2), 1, True),
    "cumprod": C(_F34, 1, grad=True),
    "cumsum": C(_I34),
    "kthvalue": C(_F34, 2, 1, True, grad=True),
    "logsumexp": C(_F34, 1, grad=True),
    "max": C(_F34, grad=True),
    "mean": C(("f", (2, 3, 4)), [0, 2], True, grad=True),
    "median": C(_F34, 1, grad=True),
    "min": C(_F34, 1, grad=True),
    "mode": C(("i", (3, 7), 0, 3), 1),
    "nanmean": C(("n", (3, 4)), 1, grad=True),
    "nanmedian": C(("n", (3, 4)), 1),
    "nansum": C(("n", (3, 4)), grad=True),
    "nonzero": C(("i", (3, 4), 0, 2)),
    "prod": C(_F34, 0, grad=True),
    "quantile": C(("f", (3, 5)), 0.3, 1, True, grad=True),
    "sort": C(_F34, 0, True, grad=True),
    "std": C(_F34, 1, grad=True),
    "sum": C(_I34, 0),
    "topk": C(("i", (3, 6), 0, 4), 2),
    "trapezoid": C(_F34, ("s", (4,)), grad=True),
    "unique": C(("i", (12,), 0, 5), return_counts=True, return_index=True),
    "var": C(_F34, [0, 1], False, grad=True),
}
_X4 = ("f", (2, 3, 6, 6))
_LOGITS, _LABELS = ("f", (4, 5)), ("i", (4,), 0, 5)
PADDLE_OP_CASES.update({
    # linalg
    "baddbmm": C(("f", (2, 3, 5)), ("f", (2, 3, 4)), ("f", (2, 4, 5)),
                 grad=True, beta=0.5, alpha=2.0),
    "bmm": C(("f", (2, 3, 4)), ("f", (2, 4, 5)), grad=True),
    "cholesky": C(("spd", 4), grad=True, tol=_LOOSE),
    "corrcoef": C(("f", (3, 6)), grad=True, tol=_LOOSE),
    "cov": C(("f", (3, 6)), grad=True),
    "cross": C(("f", (4, 3)), ("f", (4, 3)), grad=True),
    "det": C(("w", 4), grad=True, tol=_LOOSE),
    "diagonal": C(("f", (3, 4, 2)), 1, 0, 1, grad=True),
    "dist": C(_F34, _F34, 3, grad=True),
    "dot": C(_F34, _F34, grad=True),
    "eigh": C(("spd", 4), check="decomp"),
    "einsum": C("ij,jk->ik", _F34, ("f", (4, 2)), grad=True),
    "histogram": C(("f", (40,)), 6),
    "inner": C(_F34, ("f", (5, 4)), grad=True),
    "inverse": C(("w", 4), grad=True, tol=_LOOSE),
    "kron": C(("f", (2, 2)), ("f", (2, 3)), grad=True),
    "matmul": C(_F34, ("f", (5, 4)), grad=True, transpose_y=True),
    "matrix_power": C(("w", 3), 3, grad=True, tol=_LOOSE),
    "mm": C(_F34, ("f", (4, 5)), grad=True),
    "mv": C(_F34, ("f", (4,)), grad=True),
    "norm": C(_F34, grad=True),
    "outer": C(("f", (3,)), ("f", (4,)), grad=True),
    "pinv": C(("f", (4, 3)), grad=True, tol=_LOOSE),
    "qr": C(("f", (4, 3)), check="decomp"),
    "renorm": C(_F34, 2, 0, 1.5, grad=True),
    "slogdet": C(("w", 4), grad=True, tol=_LOOSE),
    "solve": C(("w", 3), ("f", (3, 2)), grad=True, tol=_LOOSE),
    "svd": C(("f", (4, 3)), check="decomp"),
    "t": C(_F34, grad=True),
    "trace": C(_F34, 1, grad=True),
    "triangular_solve": C(("tri", 3), ("f", (3, 2)), grad=True,
                          tol=_LOOSE, transpose=True),
    # nn_ops
    "adaptive_avg_pool2d": C(_X4, 3, grad=True),
    "adaptive_max_pool2d": C(_X4, 2, grad=True),
    "affine_grid": C(("f", (2, 2, 3)), [2, 1, 3, 4], grad=True),
    "alpha_dropout": C(("f", (4, 8)), 0.2, rand=True, grad=True),
    "avg_pool1d": C(("f", (2, 3, 9)), 3, 2, 1, grad=True),
    "avg_pool2d": C(_X4, 3, 2, 1, grad=True, count_include_pad=False),
    "avg_pool3d": C(("f", (1, 2, 4, 4, 4)), 3, 2, 1, grad=True),
    "batch_norm": C(_X4, ("f", (3,)), ("p", (3,)), ("f", (3,)),
                    ("f", (3,)), grad=True, tol=_LOOSE),
    "bce_loss": C(("q", (3, 4)), ("q", (3, 4)), grad=True),
    "bce_with_logits": C(_F34, ("q", (3, 4)), grad=True),
    "conv1d": C(("f", (2, 3, 8)), ("f", (4, 3, 3)), ("f", (4,)), grad=True,
                tol=_LOOSE, stride=2, padding=1),
    "conv2d": C(_X4, ("f", (4, 3, 3, 3)), ("f", (4,)), grad=True,
                tol=_LOOSE, padding=1),
    "conv2d_transpose": C(("f", (2, 3, 4, 4)), ("f", (3, 2, 3, 3)),
                          ("f", (2,)), grad=True, tol=_LOOSE, stride=2,
                          padding=1, output_padding=1),
    "conv3d": C(("f", (1, 2, 4, 4, 4)), ("f", (3, 2, 3, 3, 3)), grad=True,
                tol=_LOOSE, padding=1),
    "cosine_embedding_loss": C(_F34, _F34, ("pm", (3,)), grad=True),
    "cosine_similarity": C(_F34, _F34, grad=True),
    "cross_entropy": C(_LOGITS, _LABELS, grad=True),
    "ctc_loss": C(("f", (6, 2, 5)), ("i", (2, 3), 1, 5), [6, 5], [3, 2],
                  grad=True, tol=_LOOSE),
    "dice_loss": C(("q", (3, 5)), ("i", (3, 1), 0, 5), grad=True),
    "dropout": C(("f", (4, 8)), 0.3, rand=True, grad=True),
    "dropout2d": C(("f", (2, 4, 3, 3)), 0.5, rand=True, grad=True),
    "dropout3d": C(("f", (2, 3, 2, 2, 2)), 0.5, rand=True, grad=True),
    "embedding": C(("i", (2, 5), 0, 7), ("f", (7, 4)), grad=True,
                   padding_idx=2),
    "fold": C(("f", (1, 8, 9)), [4, 4], 2, grad=True),
    "fused_bias_dropout_residual_layer_norm": C(
        ("f", (2, 3, 8)), ("f", (2, 3, 8)), ("f", (8,)), ("f", (8,)),
        ("f", (8,)), grad=True, tol=_LOOSE),
    "global_avg_pool2d": C(("f", (2, 3, 4, 4)), grad=True),
    "grid_sample": C(("f", (1, 2, 4, 4)), ("u", (1, 3, 3, 2)), grad=True),
    "group_norm": C(("f", (2, 4, 3, 3)), 2, ("f", (4,)), ("f", (4,)),
                    grad=True, tol=_LOOSE),
    "hinge_embedding_loss": C(_F34, ("pm", (3, 4)), grad=True),
    "instance_norm": C(("f", (2, 3, 4, 4)), ("f", (3,)), ("f", (3,)),
                       grad=True, tol=_LOOSE),
    "interpolate": C(("f", (1, 2, 6, 6)), [4, 4], grad=True,
                     mode="bilinear"),
    "kl_div": C(_F34, ("q", (3, 4)), grad=True),
    "l1_loss": C(_F34, _F34, grad=True),
    "label_smooth": C(("q", (3, 4)), grad=True, epsilon=0.2),
    "layer_norm": C(("f", (2, 3, 8)), 8, ("f", (8,)), ("f", (8,)),
                    grad=True, tol=_LOOSE),
    "linear": C(("f", (2, 3, 4)), ("f", (4, 5)), ("f", (5,)), grad=True),
    "local_response_norm": C(("f", (1, 5, 3, 3)), 3, grad=True),
    "log_loss": C(("q", (3, 4)), ("q", (3, 4)), grad=True),
    "margin_cross_entropy": C(("u", (4, 5)), _LABELS, grad=True,
                              tol=_LOOSE),
    "margin_ranking_loss": C(("f", (5,)), ("f", (5,)), ("pm", (5,)),
                             grad=True),
    "max_pool1d": C(("f", (2, 3, 9)), 3, 2, 1, grad=True),
    "max_pool2d": C(_X4, 3, 2, 1, grad=True),
    "max_pool3d": C(("f", (1, 2, 4, 4, 4)), 2, grad=True),
    "mse_loss": C(_F34, _F34, grad=True),
    "nll_loss": C(_LOGITS, _LABELS, grad=True),
    "normalize": C(_F34, grad=True),
    "npair_loss": C(("f", (4, 6)), ("f", (4, 6)), ("i", (4,), 0, 2),
                    grad=True, tol=_LOOSE),
    "pixel_shuffle": C(("f", (1, 8, 2, 2)), 2, grad=True),
    "pixel_unshuffle": C(("f", (1, 2, 4, 4)), 2, grad=True),
    "rms_norm": C(("f", (2, 3, 8)), ("f", (8,)), grad=True, tol=_LOOSE),
    "scaled_dot_product_attention": C(
        ("f", (2, 8, 2, 16)), ("f", (2, 8, 2, 16)), ("f", (2, 8, 2, 16)),
        grad=True, tol=_LOOSE, is_causal=True),
    "sequence_mask": C(("i", (4,), 1, 6)),
    "sigmoid_focal_loss": C(_F34, ("q", (3, 4)), grad=True),
    "smooth_l1_loss": C(_F34, _F34, grad=True),
    "softmax_with_cross_entropy": C(_LOGITS, ("i", (4, 1), 0, 5),
                                    grad=True),
    "square_error_cost": C(_F34, _F34, grad=True),
    "temporal_shift": C(("f", (4, 4, 2, 2)), 2, grad=True),
    "triplet_margin_loss": C(_F34, _F34, _F34, grad=True),
    "unfold": C(("f", (1, 2, 5, 5)), 3, grad=True),
})
del C
# the module of each op (tanh is in activation and in math)
PADDLE_OP_MODULES = ("activation", "creation", "linalg", "manipulation",
                     "math", "nn_ops", "random_ops", "reduction")


def paddle_op_arg(spec, rng):
    """One argument of an op case: ("py", value), ("t", numpy array) or
    ("L", [arguments])."""
    if not isinstance(spec, tuple) or not spec or not isinstance(spec[0],
                                                                 str):
        return ("py", spec)
    kind, shape = spec[0], spec[1]
    if kind == "L":
        return ("L", [paddle_op_arg(s, rng) for s in shape])
    if kind == "f":
        scale = spec[2] if len(spec) > 2 else 1.0
        return ("t", (scale * rng.randn(*shape)).astype(np.float32))
    if kind == "p":
        lo = spec[2] if len(spec) > 2 else 0.5
        return ("t", rng.uniform(lo, lo + 1.5, shape).astype(np.float32))
    if kind == "u":
        return ("t", rng.uniform(-0.9, 0.9, shape).astype(np.float32))
    if kind == "q":
        return ("t", rng.uniform(0.05, 0.95, shape).astype(np.float32))
    if kind == "s":
        return ("t", np.sort(rng.randn(*shape)).astype(np.float32))
    if kind == "n":
        a = rng.randn(*shape).astype(np.float32)
        a.flat[1], a.flat[5] = np.nan, np.inf
        return ("t", a)
    if kind == "i":
        return ("t", rng.randint(spec[2], spec[3], shape).astype(np.int32))
    if kind == "b":
        return ("t", rng.rand(*shape) < 0.5)
    if kind == "c":
        return ("t", (rng.randn(*shape) + 1j * rng.randn(*shape))
                .astype(np.complex64))
    if kind == "perm":
        return ("t", rng.permutation(spec[2])[:shape].astype(np.int32))
    if kind == "spd":
        a = rng.randn(shape, shape)
        return ("t", (a @ a.T / shape + np.eye(shape)).astype(np.float32))
    if kind == "w":
        return ("t", (rng.randn(shape, shape) + 3 * np.eye(shape))
                .astype(np.float32))
    if kind == "tri":
        return ("t", (np.triu(rng.randn(shape, shape)) + 3 * np.eye(shape))
                .astype(np.float32))
    if kind == "pm":
        return ("t", rng.choice([-1.0, 1.0], shape).astype(np.float32))
    raise ValueError(spec)


def decomposition_error(name, outs, a):
    """The largest error of the decomposition `outs` of `a` (numpy): the
    reconstruction, and the orthogonality of its vectors, against the
    scale of `a`. svd (U, S, Vh), qr (Q, R), eigh (w, V)."""
    a = np.asarray(a, np.float64)
    outs = [np.asarray(o, np.float64) for o in outs]
    if name == "svd":
        u, s, vh = outs
        rec = (u * s) @ vh
        orth = [u.T @ u, vh @ vh.T]
    elif name == "qr":
        q, r = outs
        rec = q @ r
        orth = [q.T @ q]
        if np.abs(np.tril(r, -1)).max() > 0:
            return float("inf")
    else:
        w, v = outs
        rec = (v * w) @ v.T
        orth = [v.T @ v]
    scale = max(np.abs(a).max(), 1.0)
    return max([np.abs(rec - a).max() / scale]
               + [np.abs(o - np.eye(len(o))).max() for o in orth])


def paddle_op_args(name):
    """The numpy arguments of op `name`'s case, from a seed of its name."""
    rng = np.random.RandomState(sum(map(ord, name)))
    return [paddle_op_arg(a, rng) for a in PADDLE_OP_CASES[name].args]
