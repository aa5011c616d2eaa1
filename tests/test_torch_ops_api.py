"""The port's paddle ops against the JAX package's, one case per op that
`paddle_tpu/ops/ops.yaml` lists: the modules creation, math,
manipulation, reduction, activation, random_ops, linalg and nn_ops.

Each case holds the port's function to JAX's:
- its signature: parameter names, kinds and defaults, in order;
- its forward, on the same seeded numpy inputs: the dtype names equal
  (the port stores JAX's 32-bit types), integers and bools exactly, f32
  within the case's tolerance of the largest magnitude of JAX's result
  (1e-6; 1e-5 for the transcendental and special functions: digamma,
  lgamma, polygamma, i0, erf, erfinv), the random ops after `seed(7)` in
  both packages;
- where the op is differentiable, `.backward()` of the output weighted by
  a seeded cotangent: each input's gradient within 1e-5 of the largest of
  JAX's.
- its dispatches: the `OpStats.counts` of the op (forward, cotangent
  weighting and backward) equal JAX's, name by name.
The port runs on the CPU (`set_device('cpu')`). The cases are
`tools/paddle_op_cases.py`'s: phase paddle_api of `chip_smoke.py` holds the
same ops on the card to the CPU.
"""
import inspect
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

import jax

import paddle_tpu as jp
from paddle_tpu.core import dtype as jdtypes
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.ops.dispatch import OpStats as JStats
import paddle_tpu_torch as tp
from paddle_tpu.ops import (activation as jact, creation as jcre,
                            linalg as jlin, manipulation as jman,
                            math as jmath, nn_ops as jnn,
                            random_ops as jrand, reduction as jred)
from paddle_tpu_torch.core import dtype as tdtypes
from paddle_tpu_torch.ops.dispatch import OpStats as TStats
from paddle_tpu_torch.ops import (activation as tact, creation as tcre,
                                  linalg as tlin, manipulation as tman,
                                  math as tmath, nn_ops as tnn,
                                  random_ops as trand, reduction as tred)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
from paddle_op_cases import (PADDLE_OP_CASES as CASES,  # noqa: E402
                             decomposition_error, paddle_op_args)

MODULES = {"activation": (jact, tact), "creation": (jcre, tcre),
           "manipulation": (jman, tman), "math": (jmath, tmath),
           "random_ops": (jrand, trand), "reduction": (jred, tred),
           "linalg": (jlin, tlin), "nn_ops": (jnn, tnn)}
SCHEMA = yaml.safe_load((REPO / "paddle_tpu/ops/ops.yaml").read_text())
LISTED = [(o["module"], o["op"]) for o in SCHEMA["ops"]
          if o["module"] in MODULES]

# the JAX ops that need concrete values (dynamic output shapes, host
# checks, in-place updates of their argument)
EAGER = {"masked_select", "unique", "nonzero", "bincount", "take",
         "increment", "multiply_", "normal_", "uniform_", "where", "rrelu",
         "sequence_mask", "dropout", "dropout2d", "dropout3d",
         "alpha_dropout"}

GRAD_TOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port on the CPU; both packages' global generators (and default
    dtypes) as they were, for the tests that run after these."""
    states = jp.get_rng_state(), tp.get_rng_state()
    stats = [(S, S.enabled, dict(S.counts)) for S in (JStats, TStats)]
    tp.set_device("cpu")
    yield
    for S, enabled, counts in stats:
        S.enabled, S.counts = enabled, counts
    jp.set_rng_state(states[0])
    tp.set_rng_state(states[1])
    jp.set_default_dtype("float32")
    tp.set_default_dtype("float32")


def _build(arg, pkg, grad, leaves):
    kind, v = arg
    if kind == "py":
        return v
    if kind == "L":
        return [_build(a, pkg, grad, leaves) for a in v]
    diff = grad and v.dtype == np.float32
    t = pkg.to_tensor(np.array(v), stop_gradient=not diff)
    if diff:
        leaves.append(t)
    return t


def _outputs(out):
    if isinstance(out, (list, tuple)):
        return [o for x in out for o in _outputs(x)]
    return [out]


def _dtype_name(t, jax_side):
    return t.dtype if jax_side else tdtypes.canonical_name(t.dtype)


def _forward_and_grads(pkg, fn, case, built, leaves):
    """The op's outputs and, for a differentiable case, each leaf's
    gradient of the outputs weighted by seeded cotangents."""
    if case.rand:
        pkg.seed(7)
    outs = _outputs(fn(*built, **case.kw))
    grads = None
    if case.grad:
        rng = np.random.RandomState(11)
        diffs = [o for o in outs if not o.stop_gradient]
        loss = None
        for o in diffs:
            cot = pkg.to_tensor(np.asarray(rng.randn(*o.shape),
                                           np.float32))
            term = pkg.sum(pkg.multiply(o, cot)) if o.ndim else \
                pkg.multiply(o, cot)
            loss = term if loss is None else pkg.add(loss, term)
        loss.backward()
        grads = [t.grad for t in leaves]
    return outs, grads


def _counted(stats, run):
    """`run()` and the dispatches it made."""
    stats.enabled, stats.counts = True, {}
    try:
        return run(), dict(stats.counts)
    finally:
        stats.enabled = False


def _run(pkg, fn, case, args, jax_side):
    leaves = []
    built = [_build(a, pkg, case.grad, leaves) for a in args]
    outs, grads = _forward_and_grads(pkg, fn, case, built, leaves)
    if not outs or not all(hasattr(o, "numpy") for o in outs):
        return outs, [], None
    vals = [(np.asarray(o.numpy()), _dtype_name(o, jax_side)) for o in outs]
    if grads is not None:
        grads = [None if g is None else np.asarray(g.numpy())
                 for g in grads]
    return outs, vals, grads


def _run_jax(fn, case, args, name):
    """JAX's side under one `jax.jit` (one compile a case rather than one
    a primitive; the ops in `EAGER` need concrete values and run eagerly):
    the same values as the eager tape."""
    if name in EAGER:
        return _run(jp, fn, case, args, True)
    arrays = []

    def flat(a):
        kind, v = a
        if kind == "L":
            for x in v:
                flat(x)
        elif kind == "t":
            arrays.append(v)

    for a in args:
        flat(a)

    def traced(*arrs):
        it = iter(arrs)
        leaves = []

        def build(a):
            kind, v = a
            if kind == "py":
                return v
            if kind == "L":
                return [build(x) for x in v]
            arr = next(it)
            diff = case.grad and v.dtype == np.float32
            t = JTensor._wrap(arr, stop_gradient=not diff)
            if diff:
                leaves.append(t)
            return t

        built = [build(a) for a in args]
        outs, grads = _forward_and_grads(jp, fn, case, built, leaves)
        return ([o._array for o in outs],
                None if grads is None else
                [None if g is None else g._array for g in grads])

    outs, grads = jax.jit(traced)(*arrays)
    vals = [(np.asarray(o), jdtypes.canonical_name(o.dtype)) for o in outs]
    if grads is not None:
        grads = [None if g is None else np.asarray(g) for g in grads]
    return outs, vals, grads


def _close(t, j, tol, what):
    if j.dtype.kind in "biu":
        np.testing.assert_array_equal(t, j, err_msg=what)
        return
    scale = float(np.nanmax(np.abs(j))) if j.size and np.isfinite(
        j).any() else 1.0
    np.testing.assert_allclose(t, j, rtol=tol, atol=tol * max(scale, 1e-30),
                               equal_nan=True, err_msg=what)


def _params(fn):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("module,name", LISTED,
                         ids=[f"{m}.{n}" for m, n in LISTED])
def test_op_matches_jax(module, name):
    jmod, tmod = MODULES[module]
    jfn, tfn = getattr(jmod, name), getattr(tmod, name)
    assert _params(tfn) == _params(jfn)
    case = CASES[name]
    args = paddle_op_args(name)
    (jouts, jvals, jgrads), jcounts = _counted(
        JStats, lambda: _run_jax(jfn, case, args, name))
    (touts, tvals, tgrads), tcounts = _counted(
        TStats, lambda: _run(tp, tfn, case, args, False))
    assert tcounts == jcounts
    assert len(touts) == len(jouts)
    if not jvals:                       # a Python value (allclose's bool)
        assert [bool(t) for t in touts] == [bool(j) for j in jouts]
        return
    for k, ((t, td), (j, jd)) in enumerate(zip(tvals, jvals)):
        assert td == jd, f"output {k}: dtype {td} != JAX's {jd}"
        assert t.shape == j.shape, f"output {k}: {t.shape} != {j.shape}"
        if case.check is None:
            _close(t, j, case.tol, f"{name} output {k}")
    if case.check == "decomp":
        a = args[0][1]
        assert decomposition_error(name, [v for v, _ in tvals], a) < 1e-5
        assert decomposition_error(name, [v for v, _ in jvals], a) < 1e-5
        unique = {"svd": 1, "eigh": 0}.get(name)
        if unique is not None:
            _close(tvals[unique][0], jvals[unique][0], 1e-5, name)
        else:
            _close(np.abs(np.diag(tvals[1][0])),
                   np.abs(np.diag(jvals[1][0])), 1e-5, name)
    if case.grad:
        assert len(tgrads) == len(jgrads)
        for k, (t, j) in enumerate(zip(tgrads, jgrads)):
            assert (t is None) == (j is None), f"grad {k}"
            if j is not None:
                _close(t, j, GRAD_TOL, f"{name} grad {k}")


def test_every_listed_op_has_a_case():
    # `tanh` is listed under activation and math: one case serves both
    assert {n for _, n in LISTED} == set(CASES)
    assert len(LISTED) == 332 and len(CASES) == 331
