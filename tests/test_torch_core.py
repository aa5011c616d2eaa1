"""The port's paddle core against the JAX package's, on the CPU: dtypes,
places, the Tensor's members, autograd (`grad`, `run_backward`, hooks),
`PyLayer`, the generator's state, and the seeded draws: the key chain and
the raw bits bit for bit, the uniform, integer, Bernoulli, categorical and
permutation draws bit for bit, the normal and exponential transforms
within 1e-6 (torch's erfinv and log1p against XLA's), and `poisson` by its
distribution (jax's algorithm is not reproduced: ROADMAP Queue C).
"""
import numpy as np
import pytest
import torch

import jax
import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.core import dtype as jdtypes
from paddle_tpu.core import random as jrandom
from paddle_tpu_torch.core import device as tdevice
from paddle_tpu_torch.core import dtype as tdtypes
from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.ops import threefry


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port on the CPU; both packages' global generators (and default
    dtypes) as they were, for the tests that run after these."""
    states = jp.get_rng_state(), tp.get_rng_state()
    tp.set_device("cpu")
    yield
    jp.set_rng_state(states[0])
    tp.set_rng_state(states[1])
    jp.set_default_dtype("float32")
    tp.set_default_dtype("float32")


# ---------------------------------------------------------------------------
# dtypes and places
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["float32", "float64", "float16",
                                  "bfloat16", "int8", "int16", "int32",
                                  "int64", "uint8", "bool", "complex64",
                                  "complex128", "float", "double", "half",
                                  "bf16", "fp16", "fp32", "int", "long",
                                  "uint64", np.float64, np.int64, np.int8])
def test_dtype_names_match_jax(name):
    assert tdtypes.canonical_name(name) == jdtypes.canonical_name(name)
    assert tdtypes.is_floating(name) == jdtypes.is_floating(name)
    assert tdtypes.is_integer(name) == jdtypes.is_integer(name)
    assert tdtypes.is_inexact(name) == jdtypes.is_inexact(name)


@pytest.mark.parametrize("value", [True, 3, 2.5, 1j, [1, 2], [1.5, 2.0],
                                   np.zeros(2, np.int64),
                                   np.zeros(2, np.float64),
                                   np.zeros(2, np.uint8)])
def test_infer_dtype_and_default_dtype_match_jax(value):
    assert tdtypes.infer_dtype(value) == jdtypes.infer_dtype(value)
    tp.set_default_dtype("bfloat16")
    jp.set_default_dtype("bfloat16")
    try:
        assert tdtypes.infer_dtype(value) == jdtypes.infer_dtype(value)
        assert tp.get_default_dtype() == jp.get_default_dtype()
    finally:
        jp.set_default_dtype("float32")
    with pytest.raises(ValueError):
        tp.set_default_dtype("int32")


@pytest.mark.parametrize("a,b", [("int32", "float32"), ("bool", "int32"),
                                 ("int8", "uint8"), ("bfloat16", "float16"),
                                 ("bfloat16", "int32"),
                                 ("float16", "float32"), ("int8", "int16"),
                                 ("bool", "bfloat16")])
def test_promotion_matches_jnp(a, b):
    import jax.numpy as jnp

    got = tdtypes.promote_types(tdtypes.to_torch(a), tdtypes.to_torch(b))
    assert tdtypes.canonical_name(got) == jdtypes.canonical_name(
        jnp.promote_types(jdtypes.to_jax(a), jdtypes.to_jax(b)))


def test_places(monkeypatch):
    assert tp.set_device("cpu") == tdevice.Place("cpu", 0)
    assert tp.get_device() == "cpu:0"
    assert tp.to_tensor([1.0]).place == tdevice.Place("cpu", 0)
    with pytest.raises(ValueError, match="'gpu' and 'cpu'"):
        tp.set_device("tpu")
    assert tdevice.is_compiled_with_cuda() == torch.backends.cuda.is_built()
    assert tdevice.device_count() == torch.cuda.device_count()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.set_device("gpu")
    monkeypatch.setattr(tdevice, "_current_place", None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.zeros([2])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.get_device()
    assert tp.to_tensor([1.0], place="cpu").device.type == "cpu"


# ---------------------------------------------------------------------------
# the Tensor
# ---------------------------------------------------------------------------
def test_tensor_members_match_jax():
    data = np.arange(6, dtype=np.float64).reshape(2, 3)
    j, t = jp.to_tensor(data), tp.to_tensor(data)
    assert isinstance(t, tp.Tensor) and isinstance(t, torch.Tensor)
    assert tdtypes.canonical_name(t.dtype) == j.dtype == "float32"
    assert t.stop_gradient is j.stop_gradient is True
    assert list(t.shape) == j.shape and t.ndim == j.ndim
    np.testing.assert_array_equal(t.numpy(), j.numpy())
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
    ti = tp.to_tensor([1, 2], "int64")
    assert tdtypes.canonical_name(ti.dtype) == jp.to_tensor(
        [1, 2], "int64").dtype == "int32"
    a = t.astype("int64")
    assert isinstance(a, tp.Tensor) and a.dtype == torch.int32
    t.set_value(np.ones((2, 3)))
    j.set_value(np.ones((2, 3)))
    np.testing.assert_array_equal(t.numpy(), j.numpy())
    t.name, t.persistable = "w", True
    assert (t.name, t.persistable) == ("w", True)
    assert (t + 1).name == "" and isinstance(torch.relu(t), tp.Tensor)
    t.stop_gradient = False
    assert t.requires_grad and not t.stop_gradient
    y = (t * t).sum()
    assert not y.stop_gradient and y.grad_fn is not None
    y.stop_gradient = True
    assert y.grad_fn is None
    p = tp.Parameter(np.ones(3, np.float32), trainable=False)
    jparam = jp.Parameter(np.ones(3, np.float32), trainable=False)
    assert p.stop_gradient is jparam.stop_gradient is True
    assert p.persistable is jparam.persistable is True
    assert isinstance(p, torch.nn.Parameter)
    m = torch.nn.Module()
    m.w = tp.Parameter(np.ones(3, np.float32), name="w")
    assert [n for n, _ in m.named_parameters()] == ["w"]
    assert not m.w.stop_gradient and type(m.w * 2) is tp.Tensor


def _close(t, j, tol=1e-6):
    """Within `tol` of the largest magnitude of JAX's result."""
    j = np.asarray(j)
    np.testing.assert_allclose(t, j, rtol=tol,
                               atol=tol * float(np.abs(j).max()))


def _pair(seed=0, shape=(3, 4)):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return (jp.to_tensor(x, stop_gradient=False),
            tp.to_tensor(x, stop_gradient=False))


def test_backward_grad_and_clear_grad_match_jax():
    for pkg, x in zip((jp, tp), _pair()):
        y = pkg.multiply(pkg.exp(x), x)
        y.backward()                  # a non-scalar root seeds ones
        g1 = x.grad.numpy().copy()
        pkg.sum(pkg.multiply(x, x)).backward()
        g2 = x.grad.numpy()
        x.clear_grad()
        assert x.grad is None
        x.clear_gradient()
        if pkg is jp:
            want = (g1, g2)
        else:
            np.testing.assert_allclose(g1, want[0], rtol=1e-6)
            np.testing.assert_allclose(g2, want[1], rtol=1e-6)


def test_hooks_fire_once_per_leaf_with_the_summed_gradient():
    seen = {}
    for pkg, x in zip((jp, tp), _pair(1)):
        calls = []

        def hook(g, calls=calls):
            calls.append(g.numpy().copy())
            return pkg.multiply(g, 2.0)

        h = x.register_hook(hook)
        # x reaches the loss twice: the hook sees the sum, once
        loss = pkg.add(pkg.sum(pkg.multiply(x, x)), pkg.sum(pkg.exp(x)))
        loss.backward()
        seen[pkg.__name__] = (calls, x.grad.numpy())
        h.remove()
        x.clear_grad()
        pkg.sum(x).backward()
        np.testing.assert_array_equal(x.grad.numpy(), np.ones((3, 4)))
    (jc, jg), (tc, tg) = seen["paddle_tpu"], seen["paddle_tpu_torch"]
    assert len(jc) == len(tc) == 1
    np.testing.assert_allclose(tc[0], jc[0], rtol=1e-6)
    np.testing.assert_allclose(tg, jg, rtol=1e-6)


def test_non_leaf_hook_sees_its_cotangent():
    for pkg, x in zip((jp, tp), _pair(2)):
        y = pkg.exp(x)
        got = []
        y.register_hook(lambda g, got=got: got.append(g.numpy().copy()))
        pkg.sum(pkg.multiply(y, y)).backward()
        np.testing.assert_allclose(got[0], 2 * y.numpy(), rtol=1e-6)


def test_paddle_grad_matches_jax():
    res = {}
    for pkg, x in zip((jp, tp), _pair(3)):
        w = pkg.to_tensor(np.full((3, 4), 0.5, np.float32),
                          stop_gradient=False)
        unused = pkg.to_tensor(np.ones(2, np.float32), stop_gradient=False)
        y = pkg.sum(pkg.multiply(pkg.tanh(x), w))
        gx, gw, gu = pkg.grad(y, [x, w, unused], retain_graph=True)
        assert x.grad is None and w.grad is None
        gx2, gn = pkg.grad([y], [x, unused], allow_unused=True)
        assert gn is None
        cot = pkg.to_tensor(np.full((3, 4), 2.0, np.float32))
        (gz,) = pkg.grad(pkg.multiply(x, x), [x], grad_outputs=[cot])
        res[pkg.__name__] = [g.numpy() for g in (gx, gw, gu, gx2, gz)]
    for t, j in zip(res["paddle_tpu_torch"], res["paddle_tpu"]):
        np.testing.assert_allclose(t, j, rtol=1e-6)


def test_graph_freed_unless_retained_and_no_grad():
    for pkg, x in zip((jp, tp), _pair(4)):
        y = pkg.sum(pkg.exp(x))
        y.backward(retain_graph=True)
        y.backward()
        np.testing.assert_allclose(x.grad.numpy(), 2 * np.exp(x.numpy()),
                                   rtol=1e-6)
        with pytest.raises(Exception):
            y.backward()
        with pkg.no_grad():
            assert pkg.multiply(x, x).stop_gradient
            with pkg.enable_grad():
                assert not pkg.multiply(x, x).stop_gradient
        pkg.autograd.set_grad_enabled(False)
        assert not pkg.is_grad_enabled()
        pkg.autograd.set_grad_enabled(True)
        pkg.autograd.backward([pkg.sum(x)], None)
    z = tp.to_tensor([1.0])             # no grad anywhere: nothing to do
    tp.autograd.backward([z])
    assert z.grad is None


# ---------------------------------------------------------------------------
# PyLayer
# ---------------------------------------------------------------------------
def _layers(pkg):
    class CusTanh(pkg.PyLayer):
        @staticmethod
        def forward(ctx, x, k=1.0):
            y = pkg.tanh(x)
            ctx.save_for_backward(y)
            ctx.mark_not_inplace(x)
            return pkg.scale(y, k)

        @staticmethod
        def backward(ctx, dy):
            (y,) = ctx.saved_tensor()
            return pkg.multiply(dy, pkg.subtract(1.0, pkg.square(y)))

    class Pair(pkg.PyLayer):
        @staticmethod
        def forward(ctx, a, idx, b):
            return pkg.multiply(a, b), pkg.add(a, b)

        @staticmethod
        def backward(ctx, g1, g2):
            # one grad per tensor input, None for the int one
            return pkg.add(g1, g2), None, pkg.add(g1, g2)

    return CusTanh, Pair


def test_pylayer_matches_jax():
    res = {}
    for pkg, x in zip((jp, tp), _pair(5)):
        cus, pair = _layers(pkg)
        y = cus.apply(x)
        b = pkg.to_tensor(np.full((3, 4), 2.0, np.float32),
                          stop_gradient=False)
        idx = pkg.to_tensor(np.arange(3, dtype=np.int32))
        p, q = pair.apply(y, idx, b=b)
        pkg.sum(pkg.add(p, q)).backward()
        res[pkg.__name__] = (y.numpy(), x.grad.numpy(), b.grad.numpy())
        with pkg.no_grad():
            assert cus.apply(x).stop_gradient
    for t, j in zip(res["paddle_tpu_torch"], res["paddle_tpu"]):
        _close(t, j)


def test_pylayer_refuses_a_wrong_grad_count():
    class Bad(tp.PyLayer):
        @staticmethod
        def forward(ctx, a, b):
            return a * b

        @staticmethod
        def backward(ctx, g):
            return g, g, g

    _, x = _pair(6)
    with pytest.raises(RuntimeError, match="differentiable inputs"):
        tp.sum(Bad.apply(x, x)).backward()


def test_pylayer_materialize_grads():
    got = []

    class Two(tp.PyLayer):
        @staticmethod
        def forward(ctx, a):
            ctx.set_materialize_grads(False)
            return a * 2, a * 3

        @staticmethod
        def backward(ctx, g1, g2):
            got.append(g2)
            return g1 * 2

    _, x = _pair(7)
    tp.sum(Two.apply(x)[0]).backward()
    assert got == [None]
    np.testing.assert_array_equal(x.grad.numpy(), np.full((3, 4), 2.0))


# ---------------------------------------------------------------------------
# the generator and the seeded draws
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 5, 2**31 + 3, -7])
def test_key_chain_and_bits_bitwise_jax(seed):
    jg, tg = jrandom.Generator(seed), trandom.Generator(seed)
    for _ in range(3):
        jk, tk = jg.next_key(), tg.next_key()
        assert list(tk) == np.asarray(jax.random.key_data(jk)).tolist()
    got = threefry.bits(tk, (5, 7))
    want = jax.random.bits(jk, (5, 7), np.uint32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert [list(k) for k in threefry.split(tk, 3)] == np.asarray(
        jax.random.key_data(jax.random.split(jk, 3))).tolist()


def test_generator_state_round_trip():
    for pkg in (jp, tp):
        pkg.seed(11)
        pkg.rand([2])
        state = pkg.get_rng_state()
        a = pkg.rand([3]).numpy()
        pkg.rand([3])
        pkg.set_rng_state(state)
        np.testing.assert_array_equal(pkg.rand([3]).numpy(), a)
    js, ts = jp.get_rng_state(), tp.get_rng_state()
    assert (ts[0], ts[1]) == (js[0], js[1])
    assert list(ts[2]) == np.asarray(js[2]).tolist()
    g = trandom.Generator(3)
    assert g.initial_seed() == 3
    with trandom.key_scope((1, 2)):
        assert trandom.in_key_scope()
        k0, k1 = trandom.next_key(), trandom.next_key()
        with trandom.fold_key(5):
            k2 = trandom.next_key()
    assert not trandom.in_key_scope()
    jkey = jax.random.wrap_key_data(np.array([1, 2], np.uint32))
    with jrandom.key_scope(jkey):
        jk = [jrandom.next_key() for _ in range(2)]
        with jrandom.fold_key(5):
            jk.append(jrandom.next_key())
    assert [list(k) for k in (k0, k1, k2)] == [
        np.asarray(jax.random.key_data(k)).tolist() for k in jk]


def _draws(pkg, seed=21):
    pkg.seed(seed)
    p = pkg.to_tensor(np.linspace(0.05, 0.95, 64).astype(np.float32))
    probs = pkg.to_tensor(np.random.RandomState(0).rand(4, 9)
                          .astype(np.float32))
    return {
        "rand": pkg.rand([6, 5]),
        "uniform": pkg.uniform([40], min=-3.0, max=2.0),
        "randint": pkg.randint(-50, 1000, [33]),
        "randint_wide": pkg.randint(-2**31, 2**31 - 1, [17]),
        "randint_like": pkg.randint_like(
            pkg.to_tensor(np.zeros((2, 3), np.int32)), 7),
        "bernoulli": pkg.bernoulli(p),
        "multinomial": pkg.multinomial(probs, 5, replacement=True),
        "multinomial_noreplace": pkg.multinomial(probs, 3),
        "randperm": pkg.randperm(20),
        "shuffle": pkg.shuffle(pkg.to_tensor(np.arange(12).reshape(6, 2)
                                             .astype(np.float32))),
        "randn": pkg.randn([300]),
        "normal": pkg.normal(1.0, 2.0, [50]),
        "standard_normal": pkg.standard_normal([7, 3]),
        "exponential": pkg.ops.random_ops.exponential(p, 1.5),
    }


FLOAT_TRANSFORMS = ("randn", "normal", "standard_normal", "exponential")


def test_seeded_draws_match_jax():
    jd, td = _draws(jp), _draws(tp)
    for name, j in jd.items():
        t = td[name]
        assert tdtypes.canonical_name(t.dtype) == j.dtype, name
        if name in FLOAT_TRANSFORMS:
            np.testing.assert_allclose(t.numpy(), j.numpy(), rtol=0,
                                       atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(t.numpy(), j.numpy(),
                                          err_msg=name)


def test_bf16_and_f16_uniform_bitwise_jax():
    for d in ("bfloat16", "float16"):
        jp.seed(4)
        tp.seed(4)
        j = jp.rand([64], d)
        t = tp.rand([64], d)
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j.numpy(), np.float32))


def test_poisson_by_distribution():
    """jax.random.poisson's algorithm (a while loop of key splits) is not
    reproduced: the port seeds torch's Poisson sampler from the subkey, so
    a seed repeats its draws and the draws have the rate's mean and
    variance (ROADMAP Queue C)."""
    lam = tp.to_tensor(np.full(20000, 3.5, np.float32))
    tp.seed(9)
    a = tp.poisson(lam)
    tp.seed(9)
    assert torch.equal(a, tp.poisson(lam))
    assert a.dtype == torch.float32
    assert abs(a.mean().item() - 3.5) < 0.05
    assert abs(a.var().item() - 3.5) < 0.15
