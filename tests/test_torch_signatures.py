"""The port's entry points take the JAX package's parameters, by name and in
JAX's positional order, so that a caller moving from `paddle_tpu` keeps its
calls: every parameter JAX has, in JAX's order, then the port's own
(`device`, and on the layers and models `dtype` and `generator`),
keyword-only, last. `donate` is accepted and stored without effect (the
port writes pools and parameters in place); `mp_axis` takes the serving
mesh's one axis, `'mp'`, and refuses any other. The constructors of every
layer class of `nn` and of the models (Queue C 30) are held the same way.
"""
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.adapters as jad
import paddle_tpu.inference as jinf
import paddle_tpu.jit as jjit
import paddle_tpu.models.bert as jbert
import paddle_tpu.models.gpt as jgpt
import paddle_tpu.nn as jnn
import paddle_tpu.vision.models.resnet as jresnet
import paddle_tpu_torch as pt
import paddle_tpu_torch.adapters as tad
import paddle_tpu_torch.inference as tinf
import paddle_tpu_torch.models.bert as tbert
import paddle_tpu_torch.models.gpt as tgpt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.vision.models.resnet as tresnet

PORT_ONLY = ("device", "dtype", "generator")

PAIRS = {
    "TrainStep": (jjit.TrainStep.__init__, pt.TrainStep.__init__),
    "GenerationEngine": (jinf.GenerationEngine.__init__,
                         tinf.GenerationEngine.__init__),
    "PagedKVCache": (jinf.PagedKVCache.__init__, tinf.PagedKVCache.__init__),
    "PagedAdapterPool": (jad.PagedAdapterPool.__init__,
                         tad.PagedAdapterPool.__init__),
    "GenerationEngine.add_request": (jinf.GenerationEngine.add_request,
                                     tinf.GenerationEngine.add_request),
    "GenerationEngine.adopt_request": (jinf.GenerationEngine.adopt_request,
                                       tinf.GenerationEngine.adopt_request),
    "ServingFleet": (jinf.ServingFleet.__init__, tinf.ServingFleet.__init__),
    "ServingFleet.add_request": (jinf.ServingFleet.add_request,
                                 tinf.ServingFleet.add_request),
    "ServingFleet.best_of_n": (jinf.ServingFleet.best_of_n,
                               tinf.ServingFleet.best_of_n),
}


def _layer_classes():
    """{name: (JAX __init__, port __init__)} of every layer class of `nn`
    and of the models' modules that both packages define."""
    out = {}
    for jmod, tmod, prefix in ((jnn, tnn, "nn"), (jgpt, tgpt, "gpt"),
                               (jbert, tbert, "bert"),
                               (jresnet, tresnet, "resnet")):
        for n in dir(jmod):
            jc, tc = getattr(jmod, n), getattr(tmod, n, None)
            if isinstance(jc, type) and issubclass(jc, jnn.Layer) \
                    and tc is not None:
                out[f"{prefix}.{n}"] = (jc.__init__, tc.__init__)
    return out


PAIRS.update(_layer_classes())


def test_every_layer_class_is_held():
    """The layer classes of JAX's `nn` all exist in the port; the models'
    held here are the ones the port has (JAX's pipeline stages
    `GPTEmbeddingPipe` and `GPTFinalNorm` are not ported)."""
    names = {k for k in PAIRS if k.startswith("nn.")}
    assert {f"nn.{n}" for n in dir(jnn) if isinstance(getattr(jnn, n), type)
            and issubclass(getattr(jnn, n), jnn.Layer)} == names
    assert {"gpt.GPTForCausalLM", "gpt.GPTModel", "bert.BertModel",
            "bert.BertPretrainingHeads", "resnet.ResNet",
            "resnet.BottleneckBlock"} <= set(PAIRS)


def _split(fn):
    """(JAX-facing parameters as (name, kind), keyword-only extras)."""
    params = list(inspect.signature(fn).parameters.values())
    kw_only = [p.name for p in params if p.kind is p.KEYWORD_ONLY]
    rest = [(p.name, p.kind) for p in params if p.kind is not p.KEYWORD_ONLY]
    return rest, kw_only


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_parameters_are_jax_s_in_jax_s_order(name):
    jfn, tfn = PAIRS[name]
    jrest, jkw = _split(jfn)
    trest, tkw = _split(tfn)
    assert jkw == []
    var_kw = inspect.Parameter.VAR_KEYWORD
    # JAX's parameters in JAX's order; a **kwargs catch-all stays last
    assert [n for n, _ in trest] == [n for n, _ in jrest]
    assert [k for _, k in trest] == [k for _, k in jrest]
    assert set(tkw) <= set(PORT_ONLY)
    if tkw:
        params = list(inspect.signature(tfn).parameters.values())
        tail = [p.name for p in params if p.kind is not var_kw][-len(tkw):]
        assert tail == tkw                     # the port's own come last
    # defaults equal where both are plain values
    jsig, tsig = inspect.signature(jfn), inspect.signature(tfn)
    for n, _ in jrest:
        jd = jsig.parameters[n].default
        if n != "dtype" and (jd is None
                             or isinstance(jd, (bool, int, float, str))):
            assert tsig.parameters[n].default == jd, (name, n)


def _mlp(pkg, seed=0):
    """One Linear pair in each package from the same numpy weights."""
    rng = np.random.RandomState(seed)
    w = rng.randn(4, 3).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    if pkg == "jax":
        import paddle_tpu.nn as jnn

        m = jnn.Linear(4, 3)
        m.weight.set_value(paddle.to_tensor(w))
        m.bias.set_value(paddle.to_tensor(b))
        opt = paddle.optimizer.SGD(learning_rate=0.1,
                                   parameters=m.parameters())
        return m, opt
    m = torch.nn.Linear(4, 3)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(w.T.copy()))
        m.bias.copy_(torch.from_numpy(b))
    return m, pt.SGD(learning_rate=0.1, parameters=m.parameters())


def test_trainstep_fourth_positional_is_donate():
    """JAX's `TrainStep(m, opt, loss_fn, True)` is donate=True and returns
    the loss; so does the port's, with the same value."""
    rng = np.random.RandomState(1)
    x = rng.randn(5, 4).astype(np.float32)
    y = rng.randn(5, 3).astype(np.float32)
    jm, jopt = _mlp("jax")
    jstep = jjit.TrainStep(
        jm, jopt, lambda out, lab: ((out - lab) ** 2).mean(), True)
    jloss = jstep(paddle.to_tensor(x), paddle.to_tensor(y))
    tm, topt = _mlp("torch")
    tstep = pt.TrainStep(
        tm, topt, lambda out, lab: ((out - lab) ** 2).mean(), True)
    tloss = tstep(torch.from_numpy(x), torch.from_numpy(y))
    assert torch.is_tensor(tloss) and tloss.ndim == 0
    assert tstep._donate is True and tstep.with_outputs is False
    np.testing.assert_allclose(float(tloss), float(np.asarray(jloss._array)),
                               rtol=1e-6)
    assert pt.TrainStep(tm, topt, None, donate=False)._donate is False


@pytest.fixture(scope="module")
def tiny():
    cfg = pt.GPTConfig.tiny(vocab=61, hidden=32, layers=2, heads=2, seq=64)
    return pt.GPTForCausalLM(cfg, device="cpu").eval()


def test_donate_and_mp_axis_are_accepted_and_other_axes_refused(tiny):
    eng = tinf.GenerationEngine(tiny, 2, 8, None, (16, 64), None, None,
                                True, device="cpu")
    assert eng._donate is True and eng.prefill_buckets == (16, 64)
    assert not eng.chunked_prefill
    cache = tinf.PagedKVCache(2, 4, 8, 2, 16, torch.float32, None, "mp",
                              "int8", device="cpu")
    assert cache.kv_dtype == "int8" and cache.kpool.dtype == torch.int8
    with pytest.raises(ValueError, match="one axis 'mp'"):
        tinf.PagedKVCache(2, 4, 8, 2, 16, mp_axis="dp", device="cpu")
    reg = tad.AdapterRegistry(tiny.config, max_rank=2)
    pool = tad.PagedAdapterPool(reg, 3, None, None, "mp", True,
                                device="cpu")
    assert pool._donate is True and pool.num_pages == 3
    with pytest.raises(ValueError, match="one axis 'mp'"):
        tad.PagedAdapterPool(reg, 3, mp_axis="tp", device="cpu")
    # add_request's sixth positional is prefill_only, as in JAX
    rid = eng.add_request([1, 2, 3], 1, None, None, "standard", True)
    eng.run()
    blocks, _ = eng.take_handoff(rid)
    eng.release_handoff(blocks)
    assert eng.cache.leak_check() == []
