"""The port's int8 weights against the JAX package's, on the CPU.

- `quantization.quantize_absmax` and `dequantize`: codes and scales
  bitwise against JAX's at f32 and bf16, per tensor and per output
  channel (torch's `[out, in]` with `axis=0` against JAX's `[in, out]`
  with `axis=1`).
- `ops.int8_linear`'s plain version: `dequantize` then the matmul then
  the bias, against the same product from JAX's dequantized weight.
- The engine (`weight_dtype="int8"`): the tiny GPT's greedy tokens
  identical to the JAX int8-weight engine's at f32, with fp and int8 KV
  pools and at K=0 and K=2; the four projections of every layer go
  through `int8_linear` once a forward; the snapshot holds the codes of
  qkv, out, fc1 and fc2 only; `refresh_weights` re-quantizes after a
  weight edit; `generate()` stays on the live weights; the environment
  switch turns it on.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import GenerationEngine as JEngine
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.quantization import dequantize as j_dequantize
from paddle_tpu.quantization import quantize_absmax as j_quantize
from paddle_tpu_torch import (GenerationEngine, GPTConfig, GPTForCausalLM,
                              load_paddle_tpu_state)
from paddle_tpu_torch.ops.int8_linear import int8_linear
from paddle_tpu_torch.quantization import dequantize, quantize_absmax

VOCAB = 64


def _weights(dtype, shape, seed):
    """(torch weight [out, in] in `dtype`, the same values as a JAX array
    [in, out] in `dtype`)."""
    w = torch.from_numpy((0.05 * np.random.RandomState(seed).randn(*shape))
                         .astype(np.float32)).to(dtype)
    jw = jnp.asarray(w.float().numpy().T)
    return w, jw.astype(jnp.bfloat16) if dtype == torch.bfloat16 else jw


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,seed", [((48, 32), 0), ((96, 64), 1),
                                        ((7, 130), 2)])
def test_quantize_absmax_bitwise_jax(dtype, shape, seed):
    w, jw = _weights(dtype, shape, seed)
    w[0, :] = 0                                  # a channel at the floor
    jw = jw.at[:, 0].set(0)
    q, s = quantize_absmax(w, axis=0)
    jq, js = j_quantize(jw, axis=1)
    assert q.dtype == torch.int8 and s.dtype == dtype
    assert tuple(s.shape) == (shape[0], 1)
    assert (q.numpy() == np.asarray(jq).T).all()
    assert (s.float().numpy() == _np(js).T).all()
    assert float(s[0, 0]) == pytest.approx(1e-8, rel=1e-2)
    q, s = quantize_absmax(w)                    # per tensor
    jq, js = j_quantize(jw)
    assert (q.numpy() == np.asarray(jq).T).all()
    assert float(s) == float(_np(js))
    for dt, jdt in ((None, None), (dtype, jw.dtype)):
        got = dequantize(q, s, dt)
        want = j_dequantize(jq, js, jdt)
        assert got.dtype == (dt or torch.float32)
        assert (got.float().numpy() == _np(want).T).all()


def test_int8_linear_plain_is_dequantize_then_matmul():
    rng = np.random.RandomState(3)
    w, jw = _weights(torch.float32, (40, 32), 3)
    q, s = quantize_absmax(w, axis=0)
    jq, js = j_quantize(jw, axis=1)
    x = rng.randn(2, 5, 32).astype(np.float32)
    b = rng.randn(40).astype(np.float32)
    plain = int8_linear.plain_calls
    got = int8_linear(torch.from_numpy(x), q, s, torch.from_numpy(b))
    assert int8_linear.plain_calls == plain + 1
    want = jnp.matmul(jnp.asarray(x), j_dequantize(jq, js,
                                                   jnp.float32)) + b
    assert tuple(got.shape) == (2, 5, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert torch.equal(int8_linear(torch.from_numpy(x), q, s),
                       torch.from_numpy(x) @ dequantize(q, s).t())


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    kw = dict(vocab=VOCAB, hidden=32, layers=2, heads=4, seq=64)
    jm = JGPT(JConfig.tiny(**kw))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig.tiny(**kw), device="cpu")
    load_paddle_tpu_state(tm, {k: np.asarray(v._array)
                               for k, v in jm.state_dict().items()})
    return jm, tm.eval()


@pytest.fixture
def no_switches(monkeypatch):
    for var in ("PADDLE_SPEC_DECODE_K", "PADDLE_SERVE_KV_DTYPE",
                "PADDLE_SERVE_WEIGHT_DTYPE", "PADDLE_SERVE_SAMPLING",
                "PADDLE_PAGED_ATTENTION_BACKEND"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def _trace(seed=11):
    """The standard mixed trace of tests/test_engine_quantized.py: mixed
    lengths, a hot shared prefix and a block-aligned full-prefix hit."""
    rng = np.random.RandomState(seed)
    reqs = [(rng.randint(0, VOCAB, rng.randint(2, 13)).astype(np.int32),
             int(rng.randint(2, 7))) for _ in range(4)]
    shared = rng.randint(0, VOCAB, 8).astype(np.int32)
    return reqs + [(np.concatenate([shared, rng.randint(0, VOCAB, 3)])
                    .astype(np.int32), 4), (shared.copy(), 4)]


def _serve(eng, reqs):
    ids = [eng.add_request(p, n) for p, n in reqs[:3]]
    eng.step()
    ids += [eng.add_request(p, n) for p, n in reqs[3:]]
    out = eng.run()
    return [list(map(int, out[r])) for r in ids]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("K", [0, 2])
def test_int8_weight_engine_token_identical_to_jax(models, no_switches,
                                                   kv_dtype, K):
    jm, tm = models
    kw = dict(num_slots=3, block_size=4, num_blocks=64, prefill_chunk=8,
              spec_decode_k=K, kv_dtype=kv_dtype, weight_dtype="int8")
    want = _serve(JEngine(jm, attention_backend="dense", **kw), _trace())
    teng = GenerationEngine(tm, device="cpu", **kw)
    assert teng.weight_dtype == "int8"
    got = _serve(teng, _trace())
    assert got == want
    # and within the JAX package's budget of the fp engine's tokens
    # (tests/test_engine_quantized.py:41), counted as it counts them
    fp = _serve(GenerationEngine(tm, device="cpu",
                                 **dict(kw, weight_dtype=None)), _trace())
    same = sum(a == b for f, g in zip(fp, got) for a, b in zip(f, g))
    assert same / sum(max(len(f), len(g)) for f, g in zip(fp, got)) >= 0.90


def test_int8_weights_run_through_int8_linear(models, no_switches):
    """Every layer's four projections go through `int8_linear` once a
    forward; the snapshot holds only their codes; an fp engine never
    calls it."""
    _, tm = models
    eng = GenerationEngine(tm, device="cpu", num_slots=2, block_size=4,
                           weight_dtype="int8")
    assert [sorted(layer) for layer in eng._qweights] == \
        [["fc1", "fc2", "out_proj", "qkv_proj"]] * 2
    H, F = 32, 128
    assert eng.weight_snapshot_nbytes() == 2 * (3 * H * H + H * H
                                                + 2 * H * F)
    before = int8_linear.plain_calls
    eng.add_request([1, 2, 3], 3)
    eng.run()
    # one prefill chunk and two decode steps, four calls a layer each
    assert int8_linear.plain_calls - before == 3 * 4 * 2
    before = int8_linear.plain_calls
    fp = GenerationEngine(tm, device="cpu", num_slots=2, block_size=4)
    fp.add_request([1, 2, 3], 3)
    fp.run()
    assert fp.weight_snapshot_nbytes() == 0
    assert int8_linear.plain_calls == before
    tm.generate(torch.tensor([[1, 2, 3]]), max_length=6, use_cache=True)
    assert int8_linear.plain_calls == before     # generate: live weights


def test_refresh_weights_requantizes_after_an_edit(models, no_switches):
    _, tm = models
    eng = GenerationEngine(tm, device="cpu", num_slots=2, block_size=4,
                           weight_dtype="int8")
    fc1 = tm.gpt.blocks[0].mlp.fc1.weight
    old = fc1.detach().clone()
    q0, s0 = (t.clone() for t in eng._qweights[0]["fc1"])
    try:
        with torch.no_grad():
            fc1.mul_(2.0)
        assert torch.equal(eng._qweights[0]["fc1"][0], q0)   # a snapshot
        eng.refresh_weights()
        q1, s1 = eng._qweights[0]["fc1"]
        assert torch.equal(q1, q0)                # codes scale-invariant
        assert torch.equal(s1, 2 * s0)
        want = quantize_absmax(fc1.detach(), axis=0)
        assert torch.equal(q1, want[0]) and torch.equal(s1, want[1])
    finally:
        with torch.no_grad():
            fc1.copy_(old)
        eng.refresh_weights()


def test_weight_dtype_switch_and_validation(models, no_switches):
    _, tm = models
    no_switches.setenv("PADDLE_SERVE_WEIGHT_DTYPE", "int8")
    assert GenerationEngine(tm, device="cpu", num_slots=2,
                            block_size=4).weight_dtype == "int8"
    no_switches.setenv("PADDLE_SERVE_WEIGHT_DTYPE", "")
    assert GenerationEngine(tm, device="cpu", num_slots=2,
                            block_size=4).weight_dtype is None
    no_switches.delenv("PADDLE_SERVE_WEIGHT_DTYPE")
    with pytest.raises(ValueError, match="int8"):
        GenerationEngine(tm, device="cpu", num_slots=2, block_size=4,
                         weight_dtype="int4")
