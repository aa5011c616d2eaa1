"""The port's op dispatch, op schema and autocast against the JAX
package's (`paddle_tpu/ops/dispatch.py`, `ops/registry.py`,
`amp/auto_cast.py`), on the CPU.

- Under `auto_cast` O1 and O2 the output dtypes of a white-list op
  (matmul), a black-list op (softmax) and an unlisted op (add) equal
  JAX's, custom lists included, and nested contexts restore the state.
- `amp_cast` returns the gradient in the original dtype.
- The span hook gets JAX's arguments: (name, start_us, end_us, synced).
- The port's reader of its copy of ops.yaml gives `yaml.safe_load` of
  JAX's file, the copy is JAX's file byte for byte, and the port imports
  and reads its schema with `yaml` blocked (the card's machine has no
  PyYAML).
- Drift: every declared op exists in the port's module with JAX's
  signature string, every public op is declared, and the Tensor methods
  installed are the schema's `tensor_method: true` set.
The per-op `OpStats` counts are held in `tests/test_torch_ops_api.py`'s
case loop. Tolerances: dtypes and counts exactly; values within 1e-6.
"""
import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.ops.dispatch import OpStats as JStats
from paddle_tpu_torch.core import dtype as tdtypes
from paddle_tpu_torch.core.tensor import Tensor as TTensor
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.ops import tensor_methods
from paddle_tpu_torch.ops.dispatch import OpStats as TStats

from _paddle_state import paddle_state  # noqa: E402,F401

REPO = Path(__file__).resolve().parent.parent
JAX_YAML = REPO / "paddle_tpu/ops/ops.yaml"
MODULES = ("activation", "creation", "linalg", "manipulation", "math",
           "nn_ops", "random_ops", "reduction")

jamp = sys.modules["paddle_tpu.amp.auto_cast"]
tamp = sys.modules["paddle_tpu_torch.amp.auto_cast"]


def _pair(pkg, seed=0):
    rng = np.random.RandomState(seed)
    a = pkg.to_tensor(rng.randn(3, 4).astype(np.float32),
                      stop_gradient=False)
    b = pkg.to_tensor(rng.randn(4, 4).astype(np.float32),
                      stop_gradient=False)
    return a, b


def _name(t, jax_side):
    return t.dtype if jax_side else tdtypes.canonical_name(t.dtype)


def _dtypes(pkg, jax_side, **ctx):
    """Output dtypes of matmul (white), softmax (black), add (unlisted)
    and relu (listed by `custom_*` in some cases) on bf16 and f32
    inputs."""
    a, b = _pair(pkg)
    a16 = pkg.cast(a, "bfloat16")
    out = []
    with pkg.amp.auto_cast(**ctx):
        for x in (a, a16):
            out += [_name(pkg.matmul(x, b), jax_side),
                    _name(pkg.nn.functional.softmax(x), jax_side),
                    _name(pkg.add(x, x), jax_side),
                    _name(pkg.nn.functional.relu(x), jax_side)]
    return out


@pytest.mark.parametrize("ctx", [
    dict(), dict(level="O2"), dict(enable=False),
    dict(custom_white_list=["relu"]), dict(custom_black_list=["relu"]),
    dict(level="O2", custom_black_list=["add"]), dict(dtype="float16"),
], ids=["O1", "O2", "off", "white_relu", "black_relu", "O2_black_add",
        "O1_fp16"])
def test_autocast_output_dtypes_match_jax(ctx):
    assert _dtypes(tp, False, **ctx) == _dtypes(jp, True, **ctx)


def test_nested_auto_cast_restores_the_state():
    for pkg, mod in ((jp, jamp), (tp, tamp)):
        before = dict(mod.amp_state())
        with pkg.amp.auto_cast(level="O2", custom_white_list=["relu"]):
            with pkg.amp.auto_cast(enable=False):
                assert not mod.amp_state()["enabled"]
            assert mod.amp_state()["level"] == "O2"
            assert mod.amp_state()["extra_white"] == frozenset({"relu"})
        assert mod.amp_state() == before
    assert tamp.amp_state() == jamp.amp_state()
    assert tp.amp.autocast is tp.amp.auto_cast


def test_amp_lists_come_from_the_schema():
    assert tamp.WHITE_LIST == set(jamp.WHITE_LIST) == set(
        registry.amp_white())
    assert tamp.BLACK_LIST == set(jamp.BLACK_LIST) == set(
        registry.amp_black())
    assert tp.amp.WHITE_LIST is tamp.WHITE_LIST


def test_amp_cast_gradient_comes_back_in_the_original_dtype():
    grads = []
    for pkg in (jp, tp):
        a, b = _pair(pkg)
        pkg_stats = JStats if pkg is jp else TStats
        pkg_stats.enabled, pkg_stats.counts = True, {}
        with pkg.amp.auto_cast():
            y = pkg.matmul(a, b)
        pkg_stats.enabled = False
        assert pkg_stats.counts == {"amp_cast": 2, "matmul": 1}
        pkg.sum(pkg.cast(y, "float32")).backward()
        assert _name(a.grad, pkg is jp) == "float32"
        grads.append(np.asarray(a.grad.numpy()))
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sync", [False, True])
def test_span_hook_gets_jax_arguments(sync):
    calls = {}
    for pkg, S in ((jp, JStats), (tp, TStats)):
        got = []
        S.span_hook = lambda *a, _g=got: _g.append(a)
        S.sync_spans = sync
        a, b = _pair(pkg)
        pkg.add(a, a)
        pkg.argmax(a)
        S.span_hook = None
        calls[pkg.__name__] = got
    j, t = calls["paddle_tpu"], calls["paddle_tpu_torch"]
    assert [c[0] for c in t] == [c[0] for c in j] == ["add", "argmax"]
    for (tn, t0, t1, ts), (jn, j0, j1, js) in zip(t, j):
        assert type(t0) is type(j0) is int and t1 >= t0
        assert ts is js is sync


def test_opstats_counts_only_while_enabled():
    for pkg, S in ((jp, JStats), (tp, TStats)):
        S.enabled, S.counts = False, {}
        a, b = _pair(pkg)
        pkg.add(a, a)
        assert S.counts == {}
        S.enabled = True
        pkg.add(a, a)
        pkg.reshape(a, [4, 3])
        S.enabled = False
        assert S.counts == {"add": 1, "reshape": 1}


def test_registry_reader_equals_yaml():
    jax_doc = yaml.safe_load(JAX_YAML.read_text())
    assert registry._parse(JAX_YAML.read_text()) == jax_doc
    assert Path(registry.PATH).read_bytes() == JAX_YAML.read_bytes()
    assert registry.all_ops() == jax_doc["ops"]
    e = registry.get("conv2d")
    assert e["module"] == "nn_ops" and e["amp"] == "white"
    assert {"conv2d", "conv1d", "conv3d", "conv2d_transpose"} <= {
        x["op"] for x in registry.search("conv")}
    assert registry.get("no_such_op") is None


def test_registry_reader_refuses_a_malformed_schema():
    with pytest.raises(ValueError, match="ops.yaml:2"):
        registry._parse("ops:\nnot a section\n")


def test_port_reads_its_schema_without_pyyaml():
    code = ("import sys; sys.modules['yaml'] = None\n"
            "import paddle_tpu_torch as tp\n"
            "from paddle_tpu_torch.ops import registry\n"
            "from paddle_tpu_torch.amp import auto_cast as a\n"
            "import importlib; m = importlib.import_module("
            "'paddle_tpu_torch.amp.auto_cast')\n"
            "assert len(registry.all_ops()) == 332\n"
            "assert 'matmul' in m.WHITE_LIST and 'softmax_ce' in "
            "m.BLACK_LIST\n"
            "assert 'yaml' not in [k for k, v in sys.modules.items() "
            "if v is not None]\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"


def _port_module(name):
    return getattr(tp.ops, name) if hasattr(tp.ops, name) else \
        __import__(f"paddle_tpu_torch.ops.{name}", fromlist=["x"])


def test_every_declared_op_exists_with_jax_signature():
    for e in registry.all_ops():
        fn = getattr(_port_module(e["module"]), e["op"], None)
        assert callable(fn), f"{e['module']}.{e['op']} missing"
        assert str(inspect.signature(fn)) == e["signature"], e["op"]


def test_every_public_op_is_declared():
    declared = {e["op"] for e in registry.all_ops()}
    for name in MODULES:
        for op in _port_module(name).__all__:
            assert op in declared, f"{name}.{op}"


def test_installed_methods_are_the_schema_set():
    declared = {e["op"] for e in registry.all_ops()}
    want = {e["op"] for e in registry.all_ops() if e["tensor_method"]}
    installed = {n for n in tensor_methods.METHODS if n in declared}
    assert installed == want
    for n in installed:
        assert TTensor.__dict__[n] is tensor_methods.METHODS[n]
        assert n not in vars(__import__("torch").Tensor) or \
            vars(__import__("torch").Tensor)[n] is not \
            tensor_methods.METHODS[n]
