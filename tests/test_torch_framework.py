"""The port's framework tier against the JAX package's
(`paddle_tpu/framework`): flags, NaN/Inf checks, save and load, on the
CPU.

- `FLAGS_*` start from the environment (the modules reloaded),
  `set_flags` and `get_flags` raise on an unknown name, the deterministic
  flags are stored and read back.
- Eager checks: an op whose output is not finite raises
  `FloatingPointError` with JAX's message at level 0 and warns with it at
  level 3, and adds one to `nan_inf_events_total`; clean ops pass.
- `TrainStep` checks the loss and every gradient by name once a step,
  with JAX's message (`param{i}.grad`, the traced set's order).
- `save` / `load`: a file written by either package loads in the other,
  bf16 bit for bit; `return_numpy=True`; a torch `state_dict()`; a JAX
  GPT's saved `state_dict()` read by the port and bridged into the port's
  GPT gives JAX's logits within 1e-5.
"""
import importlib
import re
import sys
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.observability.metrics import get_registry as jregistry
from paddle_tpu_torch.observability.metrics import get_registry as tregistry

from _paddle_state import FLAGS, paddle_state  # noqa: F401


def _events(registry):
    return registry().counter("nan_inf_events_total").value


def test_flags_from_the_environment(monkeypatch):
    """Both flag modules re-read at import (reloaded here under a set
    environment, then again without it)."""
    mods = [sys.modules["paddle_tpu.framework.flags"],
            sys.modules["paddle_tpu_torch.framework.flags"]]
    env = {"FLAGS_check_nan_inf": "1", "FLAGS_check_nan_inf_level": "3",
           "FLAGS_cudnn_deterministic": "true",
           "FLAGS_embedding_deterministic": "1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    try:
        got = [importlib.reload(m).get_flags(list(FLAGS)) for m in mods]
    finally:
        for k in env:
            monkeypatch.delenv(k)
        for m in mods:
            importlib.reload(m)
    assert got[0] == got[1] == {
        "FLAGS_check_nan_inf": True, "FLAGS_check_nan_inf_level": 3,
        "FLAGS_cudnn_deterministic": True,
        "FLAGS_embedding_deterministic": 1}
    assert tp.get_flags("FLAGS_check_nan_inf") == {
        "FLAGS_check_nan_inf": False}


def test_set_and_get_flags_match_jax():
    for pkg in (jp, tp):
        pkg.set_flags({"FLAGS_cudnn_deterministic": "yes",
                       "FLAGS_embedding_deterministic": 2})
        with pytest.raises(ValueError, match="unknown flag"):
            pkg.set_flags({"FLAGS_no_such": 1})
        with pytest.raises(ValueError, match="unknown flag"):
            pkg.get_flags("FLAGS_no_such")
    assert tp.get_flags(list(FLAGS)) == jp.get_flags(list(FLAGS))
    assert tp.get_flags("FLAGS_cudnn_deterministic") == {
        "FLAGS_cudnn_deterministic": True}
    assert tp.framework.get_flags is tp.get_flags


def _eager_error(pkg, level):
    pkg.set_flags({"FLAGS_check_nan_inf": 1,
                   "FLAGS_check_nan_inf_level": level})
    x = pkg.to_tensor(np.array([1.0, 0.0], np.float32))
    y = pkg.to_tensor(np.array([2.0, 3.0], np.float32))
    assert np.isfinite((x * 2.0 + y).numpy()).all()   # clean ops pass
    if level >= 3:
        with pytest.warns(UserWarning, match="nan/inf") as rec:
            x / x
        return str(rec[0].message)
    with pytest.raises(FloatingPointError) as e:
        x / x
    return str(e.value)


@pytest.mark.parametrize("level", [0, 3])
def test_eager_check_matches_jax(level):
    before = _events(tregistry)
    tmsg = _eager_error(tp, level)
    assert _events(tregistry) - before == 1
    jmsg = _eager_error(jp, level)
    assert tmsg == jmsg == ("nan/inf detected in op 'divide': output[0] "
                            "(FLAGS_check_nan_inf)")


def test_eager_check_is_off_by_default():
    x = tp.to_tensor(np.array([1.0, 0.0], np.float32))
    before = _events(tregistry)
    assert np.isnan((x / x).numpy()[1])
    assert _events(tregistry) == before


def _jax_step_message(level):
    jp.seed(0)
    net = jp.nn.Linear(4, 4)
    opt = jp.optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
    step = jp.jit.TrainStep(net, opt, jp.nn.functional.mse_loss)
    x = jp.to_tensor(np.ones((2, 4), np.float32) * 1e20)
    y = jp.to_tensor(np.zeros((2, 4), np.float32))
    jp.set_flags({"FLAGS_check_nan_inf": 1,
                  "FLAGS_check_nan_inf_level": level})
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        try:
            float(step(x, y))
        except Exception as e:  # noqa: BLE001 — jax wraps the callback's
            return str(e)
    return " ".join(str(w.message) for w in rec)


def _port_step_message(level):
    net = torch.nn.Linear(4, 4)
    opt = tp.SGD(learning_rate=0.1, parameters=net.parameters())
    step = tp.TrainStep(net, opt, tp.nn.functional.mse_loss)
    x = torch.ones((2, 4)) * 1e20
    y = torch.zeros((2, 4))
    tp.set_flags({"FLAGS_check_nan_inf": 1,
                  "FLAGS_check_nan_inf_level": level})
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        try:
            step(x, y)
        except FloatingPointError as e:
            return str(e)
    return " ".join(str(w.message) for w in rec)


@pytest.mark.parametrize("level", [0, 3])
def test_train_step_check_matches_jax(level):
    """At level 3 both report the loss's op, then the step's loss and
    grads; at level 0 the first report raises."""
    pat = re.compile(r"nan/inf detected in [^()]*\(FLAGS_check_nan_inf\)")
    tb, jb = _events(tregistry), _events(jregistry)
    tmsgs = pat.findall(_port_step_message(level))
    jmsgs = pat.findall(_jax_step_message(level))
    want = ["nan/inf detected in op 'mse_loss': output[0] "
            "(FLAGS_check_nan_inf)",
            "nan/inf detected in compiled train step: loss, param0.grad "
            "(FLAGS_check_nan_inf)"]
    if level >= 3:
        assert tmsgs == jmsgs == want
    else:
        assert tmsgs == want[:1] and jmsgs[0] == want[0]
    assert _events(tregistry) - tb == len(tmsgs)
    assert _events(jregistry) - jb >= 1


def _state(pkg):
    rng = np.random.RandomState(0)
    return {"w": pkg.to_tensor(rng.randn(3, 4).astype(np.float32)),
            "h": pkg.cast(pkg.to_tensor(rng.randn(5).astype(np.float32)),
                          "bfloat16"),
            "i": pkg.to_tensor(np.arange(4, dtype=np.int32)),
            "nested": [pkg.to_tensor(np.ones(2, np.float32)), 7, "x"],
            "step": 3}


def _bits(t, jax_side):
    a = np.asarray(t._array) if jax_side else None
    if jax_side:
        return a.view(np.uint16) if a.dtype.name == "bfloat16" else a
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


@pytest.mark.parametrize("writer,reader", [(jp, tp), (tp, jp), (tp, tp)],
                         ids=["jax_to_port", "port_to_jax", "port"])
def test_save_load_across_packages(tmp_path, writer, reader):
    path = str(tmp_path / "sub" / "state.pdparams")
    src = _state(writer)
    writer.save(src, path)
    got = reader.load(path)
    assert set(got) == set(src) and got["step"] == 3
    assert got["nested"][1:] == [7, "x"]
    for k in ("w", "h", "i"):
        np.testing.assert_array_equal(_bits(got[k], reader is jp),
                                      _bits(src[k], writer is jp))
    assert str(got["h"].dtype).endswith("bfloat16")
    raw = reader.load(path, return_numpy=True)
    assert isinstance(raw["w"], np.ndarray)
    assert raw["h"]["__paddle_tpu_bf16__"] is True


def test_save_takes_a_torch_state_dict(tmp_path):
    net = torch.nn.Linear(3, 2).to(torch.bfloat16)
    path = str(tmp_path / "net.pdparams")
    tp.save(net.state_dict(), path)
    back = jp.load(path)
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(
            np.asarray(back[k]._array).view(np.uint16),
            v.view(torch.int16).numpy().view(np.uint16))


def test_jax_gpt_state_loads_into_the_port(tmp_path):
    from paddle_tpu.models.gpt import GPTConfig as JCfg
    from paddle_tpu.models.gpt import GPTForCausalLM as JGPT

    jp.seed(3)
    jm = JGPT(JCfg.tiny())
    jm.eval()
    path = str(tmp_path / "gpt.pdparams")
    jp.save(jm.state_dict(), path)
    arrays = tp.load(path, return_numpy=True)
    tm = tp.GPTForCausalLM(tp.GPTConfig.tiny(), device="cpu")
    tp.load_paddle_tpu_state(tm, arrays)
    tm.eval()
    ids = np.random.RandomState(1).randint(0, 128, (2, 16)).astype(np.int32)
    jl = np.asarray(jm(jp.to_tensor(ids)).numpy())
    with torch.no_grad():
        tl = tm(torch.as_tensor(ids).long()).numpy()
    np.testing.assert_allclose(tl, jl, rtol=1e-5,
                               atol=1e-5 * np.abs(jl).max())
