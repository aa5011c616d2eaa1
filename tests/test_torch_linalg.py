"""The port's linear algebra against the JAX package's
(`paddle_tpu/ops/linalg.py`, `paddle_tpu/linalg.py`), on the CPU, beyond
the one case an op of `tests/test_torch_ops_api.py`:

- the namespaces: `paddle.linalg` and the top-level exports name what
  JAX's do;
- `matmul`'s forms (transposes, vectors, broadcast batches, integers) and
  bf16's one rounding of the fp32 product, bit for bit JAX's;
- `norm`'s p and axis forms and `dist`;
- the decompositions by what is unique: `svd`'s and `eigh`'s values, the
  reconstruction and orthogonality of their vectors (within 1e-5; the
  signs are LAPACK's choice) and `qr`'s modes. JAX's eager tape cannot
  differentiate them (its vjp gets a tuple for its SVDResult, EighResult,
  QRResult), so the port's gradients of sign-invariant functions are held
  to their closed forms: d sum(S)/dA = U Vh, d sum(w^2)/dA = V diag(2w)
  V^T, d sum(QR)/dA = ones;
- `histogram` over the data's range and a given one, `cov` with weights,
  `corrcoef` and `cov` with `rowvar=False`, `triangular_solve`'s forms,
  batched `det` and `slogdet`.
Tolerance: 1e-5 of the largest magnitude of JAX's result unless stated.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from _paddle_state import paddle_state  # noqa: F401


def _np(t):
    return np.asarray(t.numpy())


def _close(t, j, tol=1e-5):
    t, j = _np(t), _np(j)
    assert t.shape == j.shape
    if j.dtype.kind in "biu":
        np.testing.assert_array_equal(t, j)
        return
    np.testing.assert_allclose(t, j, rtol=tol,
                               atol=tol * max(np.abs(j).max(), 1e-30))


def _both(fn, *arrays, grad=False):
    """fn(pkg, *tensors) in both packages; with `grad`, also the gradients
    of sum(out) w.r.t. every input."""
    res = []
    for pkg in (tp, jp):
        ts = [pkg.to_tensor(a, stop_gradient=not grad) for a in arrays]
        out = fn(pkg, *ts)
        gs = []
        if grad:
            pkg.sum(out).backward()
            gs = [t.grad for t in ts]
        res.append((out, gs))
    return res


def test_namespaces_match_jax():
    import paddle_tpu.linalg as jl

    assert tp.linalg.__all__ == jl.__all__
    for name in jl.__all__:
        assert getattr(tp.linalg, name) is getattr(tp.ops.linalg, name)
    for name in ("bmm", "cross", "det", "diagonal", "dist", "dot", "eigh",
                 "histogram", "inner", "inverse", "kron", "matmul", "mm",
                 "mv", "norm", "outer", "pinv", "qr", "slogdet", "solve",
                 "svd", "t", "trace", "einsum", "baddbmm", "renorm",
                 "corrcoef", "cov"):
        assert getattr(tp, name) is getattr(tp.ops.linalg, name)
        assert hasattr(jp, name)


RNG = np.random.RandomState(4)
A34 = RNG.randn(3, 4).astype(np.float32)
B45 = RNG.randn(4, 5).astype(np.float32)


@pytest.mark.parametrize("form", ["tx", "ty", "txy", "vec_mat", "mat_vec",
                                  "vec_vec", "batch_bcast", "int"])
def test_matmul_forms_match_jax(form):
    a, b, kw = {
        "tx": (A34.T.copy(), B45, dict(transpose_x=True)),
        "ty": (A34, B45.T.copy(), dict(transpose_y=True)),
        "txy": (A34.T.copy(), B45.T.copy(),
                dict(transpose_x=True, transpose_y=True)),
        "vec_mat": (A34[0, :3].copy(), A34, {}),
        "mat_vec": (A34, B45[:, 0].copy(), {}),
        "vec_vec": (A34[0], A34[1], {}),
        "batch_bcast": (RNG.randn(2, 1, 3, 4).astype(np.float32),
                        RNG.randn(5, 4, 2).astype(np.float32), {}),
        "int": (np.arange(12, dtype=np.int32).reshape(3, 4),
                np.arange(8, dtype=np.int32).reshape(4, 2), {}),
    }[form]
    grad = form != "int"
    (t, tg), (j, jg) = _both(lambda p, x, y: p.matmul(x, y, **kw), a, b,
                             grad=grad)
    _close(t, j)
    for x, y in zip(tg, jg):
        _close(x, y)


def test_bf16_matmul_rounds_once_as_jax():
    a = RNG.randn(16, 64).astype(np.float32)
    b = RNG.randn(64, 8).astype(np.float32)
    out = []
    for pkg in (tp, jp):
        x = pkg.cast(pkg.to_tensor(a), "bfloat16")
        y = pkg.cast(pkg.to_tensor(b), "bfloat16")
        out.append(pkg.cast(pkg.matmul(x, y), "float32").numpy())
    np.testing.assert_array_equal(out[0], out[1])


@pytest.mark.parametrize("p", ["fro", 2, float("inf"), float("-inf"), 0, 1,
                               3])
@pytest.mark.parametrize("axis,keepdim", [(None, False), (-1, True),
                                          ([0, 1], False)])
def test_norm_forms_match_jax(p, axis, keepdim):
    x = A34.copy()
    if p == 0:
        x[0, 1] = 0.0      # |x|'s gradient at 0 is 1 in JAX, 0 in torch
    (t, tg), (j, jg) = _both(
        lambda pkg, a: pkg.linalg.norm(a, p=p, axis=axis, keepdim=keepdim),
        x, grad=p not in (0, float("inf"), float("-inf")))
    _close(t, j)
    for a, b in zip(tg, jg):
        _close(a, b)


def test_dist_matches_jax():
    for p in (1, 2, 2.5, float("inf")):
        (t, _), (j, _) = _both(lambda pkg, a, b: pkg.dist(a, b, p), A34,
                               A34[::-1].copy())
        _close(t, j)


def _decomp(pkg, name, a, grad=True, **kw):
    x = pkg.to_tensor(a, stop_gradient=not grad)
    outs = getattr(pkg.linalg, name)(x, **kw)
    return x, outs if isinstance(outs, tuple) else (outs,)


@pytest.mark.parametrize("shape,full", [((5, 3), False), ((3, 5), False),
                                        ((4, 4), True), ((2, 4, 3), False)])
def test_svd_by_values_reconstruction_and_gradient(shape, full):
    a = RNG.randn(*shape).astype(np.float32)
    vals = []
    for pkg in (tp, jp):
        x, (u, s, vh) = _decomp(pkg, "svd", a, full_matrices=full)
        k = s.shape[-1]
        un, sn, vn = _np(u), _np(s), _np(vh)
        rec = (un[..., :k] * sn[..., None, :]) @ vn[..., :k, :]
        np.testing.assert_allclose(rec, a, atol=1e-5 * np.abs(a).max())
        for q in (un, np.swapaxes(vn, -1, -2)):
            eye = np.swapaxes(q, -1, -2) @ q
            np.testing.assert_allclose(eye, np.broadcast_to(
                np.eye(eye.shape[-1]), eye.shape), atol=1e-5)
        vals.append(s)
        if pkg is tp:
            tp.sum(s).backward()
            np.testing.assert_allclose(
                _np(x.grad), un[..., :k] @ vn[..., :k, :], atol=1e-5)
    _close(*vals)


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_eigh_by_values_reconstruction_and_gradient(uplo):
    m = RNG.randn(4, 4).astype(np.float32)
    a = (m @ m.T / 4 + np.eye(4)).astype(np.float32)
    vals = []
    for pkg in (tp, jp):
        x, (w, v) = _decomp(pkg, "eigh", a, UPLO=uplo)
        wn, vn = _np(w), _np(v)
        np.testing.assert_allclose((vn * wn) @ vn.T, a, atol=1e-5 * 4)
        np.testing.assert_allclose(vn.T @ vn, np.eye(4), atol=1e-5)
        vals.append(w)
        if pkg is tp:
            tp.sum(tp.multiply(w, w)).backward()
            g = _np(x.grad)
            np.testing.assert_allclose(g, (vn * 2 * wn) @ vn.T, atol=1e-4)
    _close(*vals)


@pytest.mark.parametrize("mode", ["reduced", "complete", "r"])
def test_qr_modes_by_reconstruction(mode):
    a = RNG.randn(5, 3).astype(np.float32)
    res = {}
    for pkg in (tp, jp):
        # JAX's eager tape takes the vjp at the forward, and has none for
        # the complete mode
        x, outs = _decomp(pkg, "qr", a, grad=mode == "reduced", mode=mode)
        if mode == "r":
            (r,) = outs
            res[pkg.__name__] = np.abs(np.diag(_np(r)))
            continue
        q, r = (_np(o) for o in outs)
        np.testing.assert_allclose(q @ r, a, atol=1e-5 * np.abs(a).max())
        np.testing.assert_allclose(q.T @ q, np.eye(q.shape[1]), atol=1e-5)
        assert np.abs(np.tril(r, -1)).max() == 0
        if pkg is tp and mode == "reduced":
            tp.sum(tp.matmul(outs[0], outs[1])).backward()
            np.testing.assert_allclose(_np(x.grad), np.ones_like(a),
                                       atol=1e-5)
        res[pkg.__name__] = np.abs(np.diag(r))
    np.testing.assert_allclose(res["paddle_tpu_torch"], res["paddle_tpu"],
                               rtol=1e-5)


@pytest.mark.parametrize("bins,lo,hi", [(5, 0, 0), (4, -1.0, 1.5),
                                        (3, 0.5, 0.5)])
def test_histogram_matches_jax(bins, lo, hi):
    x = np.concatenate([RNG.randn(30), [-2.0, 3.0]]).astype(np.float32)
    (t, _), (j, _) = _both(lambda p, a: p.histogram(a, bins, lo, hi), x)
    _close(t, j)
    (t, _), (j, _) = _both(lambda p, a: p.histogram(a, 4),
                           np.arange(10, dtype=np.int32))
    _close(t, j)


def test_cov_corrcoef_forms_match_jax():
    x = RNG.randn(3, 6).astype(np.float32)
    fw = np.array([1, 2, 1, 3, 1, 1], np.int32)
    aw = np.abs(RNG.randn(6)).astype(np.float32) + 0.1
    for kw in (dict(), dict(ddof=False), dict(fweights=fw),
               dict(aweights=aw), dict(fweights=fw, aweights=aw)):
        res = []
        for pkg in (tp, jp):
            k = {n: pkg.to_tensor(v) for n, v in kw.items()
                 if n != "ddof"}
            k.update({n: v for n, v in kw.items() if n == "ddof"})
            res.append(pkg.cov(pkg.to_tensor(x), **k))
        _close(*res)
    for fn in (lambda p, a: p.cov(a, rowvar=False),
               lambda p, a: p.corrcoef(a, rowvar=False)):
        (t, tg), (j, jg) = _both(fn, x.T.copy(), grad=True)
        _close(t, j)
        _close(tg[0], jg[0])


@pytest.mark.parametrize("upper,transpose,unit", [
    (True, False, False), (False, False, False), (True, True, False),
    (False, True, True)])
def test_triangular_solve_forms_match_jax(upper, transpose, unit):
    m = RNG.randn(4, 4).astype(np.float32) + 4 * np.eye(4, dtype=np.float32)
    m = np.triu(m) if upper else np.tril(m)
    b = RNG.randn(4, 2).astype(np.float32)
    (t, tg), (j, jg) = _both(lambda p, a, y: p.linalg.triangular_solve(
        a, y, upper=upper, transpose=transpose, unitriangular=unit), m, b,
        grad=True)
    _close(t, j)
    _close(tg[1], jg[1])


def test_batched_det_slogdet_inverse_solve_match_jax():
    a = (RNG.randn(3, 4, 4) + 3 * np.eye(4)).astype(np.float32)
    b = RNG.randn(3, 4, 2).astype(np.float32)
    for fn in (lambda p, x: p.det(x), lambda p, x: p.slogdet(x)[1],
               lambda p, x: p.inverse(x), lambda p, x: p.pinv(x),
               lambda p, x: p.linalg.matrix_power(x, -2)):
        (t, tg), (j, jg) = _both(fn, a, grad=True)
        _close(t, j)
        _close(tg[0], jg[0], 1e-4)
    (t, _), (j, _) = _both(lambda p, x, y: p.solve(x, y), a, b)
    _close(t, j)
