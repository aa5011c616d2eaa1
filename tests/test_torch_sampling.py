"""The port's sampled serving against the JAX package's, on the CPU.

- The PRNG (`paddle_tpu_torch.ops.threefry`): `key_row` over seeds across
  the 64-bit range, `fold_in`, the random bits and the uniforms bitwise
  against `jax.random`; the Gumbel within two f32 ulps (ROADMAP Queue C
  21: XLA's CPU log and torch's differ in the last bit).
- The ops (`paddle_tpu_torch.ops.sampling`): `masked_logits` exact on its
  -inf pattern and within 1e-6 elsewhere, `sample_token` and
  `verify_window` token for token, over seeded rows at V 128 and 50,304.
- The engine: the tiny GPT through both engines at f32 (JAX's dense
  backend, `sampling=True`, greedy and sampled lanes, K=0 and K=4): the
  same streams, token for token. Then the contracts of
  tests/test_engine_sampling.py: greedy lanes bit-exact to a
  `sampling=False` engine, seeds reproduce, a None seed resolves from the
  engine's counter, `best_of_n` seats the prompt's blocks once, the
  validation, the environment switch, `sampled_tokens`, and chi-squares
  of `sample_token` and of the rejection-sampling acceptance against
  `oracle_probs`.
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import GenerationEngine as JEngine
from paddle_tpu.inference import SamplingParams as JParams
from paddle_tpu.inference.sampling import key_row as j_key_row
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.ops import sampling as jsops
from paddle_tpu_torch import (GenerationEngine, GPTConfig, GPTForCausalLM,
                              load_paddle_tpu_state)
from paddle_tpu_torch.inference import SamplingParams
from paddle_tpu_torch.inference.sampling import key_row, oracle_probs
from paddle_tpu_torch.ops import sampling as tsops
from paddle_tpu_torch.ops import threefry
from paddle_tpu_torch.utils.cpp_extension import CSRC

VOCAB = 64


# ---------------------------------------------------------------------------
# the PRNG
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2**32 + 5, -7, 2**63 + 11,
                                  123456789012345])
def test_key_row_bitwise_jax(seed):
    got = key_row(seed)
    assert got.dtype == torch.int64 and tuple(got.shape) == (2,)
    assert got.tolist() == np.asarray(j_key_row(seed)).tolist()


def _jkey(seed):
    return jnp.asarray(j_key_row(seed), jnp.uint32)


def _tkey(seed):
    k = key_row(seed)
    return k[0], k[1]


def test_fold_in_bitwise_jax():
    for seed, data in ((3, 0), (3, 1), (2**40 + 9, 2**31 + 3),
                       (-1, 2**32 - 1)):
        want = np.asarray(jax.random.fold_in(_jkey(seed),
                                             np.uint32(data)))
        got = threefry.fold_in(_tkey(seed), data)
        assert [int(g) for g in got] == want.tolist()
    # a vector of keys and data at once, as the draws fold positions
    seeds = [5, 6, 7]
    keys = torch.stack([key_row(s) for s in seeds])
    pos = torch.tensor([0, 17, 2047])
    got = threefry.fold_in((keys[:, 0], keys[:, 1]), pos)
    for i, s in enumerate(seeds):
        want = np.asarray(jax.random.fold_in(_jkey(s), int(pos[i])))
        assert [int(got[0][i]), int(got[1][i])] == want.tolist()


@pytest.mark.parametrize("V", [128, 50304])
def test_random_bits_and_uniform_bitwise_jax(V):
    for seed in (0, 99):
        jk, tk = _jkey(seed), _tkey(seed)
        want = np.asarray(jax.random.bits(jk, (V,), jnp.uint32))
        assert (threefry.random_bits32(tk, V).numpy()
                == want.astype(np.int64)).all()
        for minval in (0.0, threefry.TINY):
            want = np.asarray(jax.random.uniform(jk, (V,), minval=minval))
            got = threefry.uniform(tk, V, minval).numpy()
            assert (got.view(np.int32) == want.view(np.int32)).all()
    # the scalar uniform of the acceptance coin
    want = np.asarray(jax.random.uniform(_jkey(4)))
    assert threefry.uniform(_tkey(4), 1)[0].numpy().view(np.int32) \
        == want.view(np.int32)


@pytest.mark.parametrize("V", [128, 50304])
def test_gumbel_within_two_ulps_of_jax(V):
    """Bitwise up to the logs: the uniforms under the Gumbel are JAX's bit
    for bit (above); XLA's CPU log and torch's differ in the last bit on
    about 14 % of inputs, so -log(-log(u)) differs by up to two ulps of
    its value plus the inner log's rounding carried out (ROADMAP Queue C
    21). A draw differs only where two candidates' perturbed logits lie
    within that of each other."""
    for seed in (0, 99):
        want = np.asarray(jax.random.gumbel(_jkey(seed), (V,)))
        got = threefry.gumbel(_tkey(seed), V).numpy()
        ulp = np.spacing(np.abs(want).astype(np.float32))
        assert (np.abs(got - want) <= 2 * ulp + 1.2e-7).all()


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------
def _rows(N, V, seed):
    """Seeded logits and per-row params over every mix: greedy rows, top-k
    on and off, the nucleus on and off."""
    rng = np.random.RandomState(seed)
    lg = (3 * rng.randn(N, V)).astype(np.float32)
    temps = rng.choice([0.0, 0.7, 1.0, 1.3], N).astype(np.float32)
    tks = rng.choice([0, 1, 5, 50], N).astype(np.int32)
    tps = rng.choice([1.0, 0.9, 0.5], N).astype(np.float32)
    seeds = rng.randint(0, 2**31, N)
    pos = rng.randint(0, 2000, N).astype(np.int32)
    return lg, temps, tks, tps, seeds, pos


def _key_rows(seeds):
    return (jnp.asarray(np.stack([np.asarray(j_key_row(s))
                                  for s in seeds])),
            torch.stack([key_row(s) for s in seeds]))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("V", [128, 50304])
def test_masked_logits_matches_jax(V):
    """Exact on the -inf pattern and within 1e-6 elsewhere wherever a mask
    cuts: top-k on, or the nucleus below 1. A row with top-k off and
    top_p 1.0 is held apart: its nucleus test `cum - p < 1.0` still cuts
    the far tail where the fp32 cumulative sum reaches 1.0, and torch's
    and XLA's exp and cumsum round differently there, so the cut moves
    among tokens of probability below 1e-6 (ROADMAP Queue C 21)."""
    lg, temps, tks, tps, _, _ = _rows(24, V, 1)
    want = np.asarray(jsops.masked_logits(jnp.asarray(lg), temps, tks, tps))
    got = tsops.masked_logits(*_t(lg, temps, tks, tps)).numpy()
    for r in range(len(lg)):
        inf_w, inf_g = np.isinf(want[r]), np.isinf(got[r])
        both = ~inf_w & ~inf_g
        np.testing.assert_allclose(got[r][both], want[r][both], atol=1e-6,
                                   rtol=1e-6)
        if tks[r] > 0 or tps[r] < 1.0:
            assert (inf_w == inf_g).all(), r
        else:
            z = lg[r].astype(np.float64) / (temps[r] if temps[r] > 0
                                             else 1.0)
            p = np.exp(z - z.max())
            p /= p.sum()
            assert (p[inf_w != inf_g] < 1e-6).all(), r


@pytest.mark.parametrize("V", [128, 50304])
def test_sample_token_identical_to_jax(V):
    lg, temps, tks, tps, seeds, pos = _rows(32, V, 2)
    jk, tk = _key_rows(seeds)
    want = np.asarray(jsops.sample_token(jnp.asarray(lg), temps, tks, tps,
                                         jk, pos))
    got = tsops.sample_token(*_t(lg, temps, tks, tps), tk.contiguous(),
                             *_t(pos))
    assert got.dtype == torch.int32
    assert got.numpy().tolist() == want.tolist()
    # greedy rows are the literal argmax
    g = temps <= 0
    assert (got.numpy()[g] == lg[g].argmax(-1)).all()


@pytest.mark.parametrize("V", [128, 50304])
def test_verify_window_identical_to_jax(V):
    """Choices and accepts over windows of W 5 with draft lengths 0-4;
    half the drafts are the row's argmax, so coins and equality both
    accept and reject."""
    B, W = 12, 5
    lg, temps, tks, tps, seeds, pos = _rows(B, V, 3)
    rng = np.random.RandomState(4)
    lg3 = (3 * rng.randn(B, W, V)).astype(np.float32)
    toks = rng.randint(0, V, (B, W)).astype(np.int32)
    hit = rng.rand(B, W - 1) < 0.5
    toks[:, 1:] = np.where(hit, lg3[:, :-1].argmax(-1), toks[:, 1:])
    dl = rng.randint(0, W, B).astype(np.int32)
    jk, tk = _key_rows(seeds)
    jc, ja = jsops.verify_window(jnp.asarray(lg3), jnp.asarray(toks),
                                 jnp.asarray(dl), temps, tks, tps, jk, pos)
    tc, ta = tsops.verify_window(*_t(lg3, toks, dl, temps, tks, tps),
                                 tk.contiguous(), *_t(pos))
    assert tc.numpy().tolist() == np.asarray(jc).tolist()
    assert ta.numpy().tolist() == np.asarray(ja).tolist()
    assert ta.any() and not ta.all()


@pytest.mark.parametrize("exclude", [False, True])
def test_verify_draws_plain_path_is_the_two_plain_draws(exclude):
    """The verify step's fused entry on a CPU tensor: its tokens are
    `sample_draw_plain`'s under the sample salt and its coins bitwise
    `sample_uniform_plain`'s under the accept salt, on the same key rows
    and positions; no launch, and one call of each plain version, counted
    where the plain versions count them (`sample_draw_plain` under
    `sample_draw`, `sample_uniform_plain` under `verify_draws`).
    `verify_window` takes it once a window, and no other draw."""
    N, V = 10, 333
    rng = np.random.RandomState(8)
    lg = torch.from_numpy((3 * rng.randn(N, V)).astype(np.float32))
    keys = torch.stack([key_row(s) for s in range(N)])
    pos = torch.from_numpy(rng.randint(0, 2048, N).astype(np.int32))
    ex = torch.where(torch.arange(N) % 2 == 0, lg.argmax(-1), -1) \
        .to(torch.int32) if exclude else None
    counts = (tsops.sample_draw.plain_calls, tsops.verify_draws.plain_calls,
              tsops.sample_draw.launches, tsops.verify_draws.launches)
    tok, u = tsops.verify_draws(lg, keys, pos, ex)
    assert (tsops.sample_draw.plain_calls - counts[0],
            tsops.verify_draws.plain_calls - counts[1],
            tsops.sample_draw.launches - counts[2],
            tsops.verify_draws.launches - counts[3]) == (1, 1, 0, 0)
    assert tok.dtype == torch.int32 and u.dtype == torch.float32
    assert torch.equal(tok, tsops.sample_draw_plain(
        lg, keys, pos, tsops.SALT_SAMPLE, ex))
    assert torch.equal(u.view(torch.int32), tsops.sample_uniform_plain(
        keys, pos, tsops.SALT_ACCEPT).view(torch.int32))
    if exclude:
        assert (tok[::2] != ex[::2]).all()
    B, W = 2, 5
    draws, fused = tsops.sample_draw.plain_calls, \
        tsops.verify_draws.plain_calls
    tsops.verify_window(lg[:B * W].view(B, W, V), torch.zeros(
        (B, W), dtype=torch.int32), torch.tensor([4, 2], dtype=torch.int32),
        torch.tensor([0.8, 0.0]), torch.tensor([0, 0], dtype=torch.int32),
        torch.tensor([1.0, 1.0]), keys[:B].contiguous(), pos[:B])
    assert (tsops.sample_draw.plain_calls - draws,
            tsops.verify_draws.plain_calls - fused) == (1, 1)


def test_verify_window_greedy_rows_reproduce_equality_contract():
    """Greedy rows: accepts is argmax equality on the drafted columns and
    choices pin the argmax chain (the port of the JAX test)."""
    rng = np.random.RandomState(5)
    lg = rng.randn(3, 3, 8).astype(np.float32)
    am = lg.argmax(-1)
    tokens = np.zeros((3, 3), np.int32)
    tokens[0, 1:] = am[0, :2]
    tokens[1, 1] = (am[1, 0] + 1) % 8
    tokens[2, 1:] = am[2, :2]
    choices, accepts = tsops.verify_window(
        *_t(lg, tokens, np.array([2, 2, 0], np.int32)),
        torch.zeros(3), torch.zeros(3, dtype=torch.int32), torch.ones(3),
        torch.zeros((3, 2), dtype=torch.int64),
        torch.zeros(3, dtype=torch.int32))
    assert (choices.numpy() == am).all()
    assert accepts.numpy().tolist() == [[True, True, False],
                                        [False, False, False],
                                        [False, False, False]]


# ---------------------------------------------------------------------------
# the statistical acceptance tests, against the numpy oracle
# ---------------------------------------------------------------------------
N_DRAWS = 20000


def _chi2_crit(dof):
    from scipy import stats

    return float(stats.chi2.isf(1e-3, dof))


def _chi2(counts, probs, n):
    exp = probs * n
    keep = exp > 0
    assert counts[~keep].sum() == 0, "draws landed on zero-probability " \
        "tokens"
    return float(((counts[keep] - exp[keep]) ** 2 / exp[keep]).sum()), \
        int(keep.sum()) - 1


def _draw_keys(n=N_DRAWS, seed=123):
    """n distinct per-slot key rows."""
    return torch.from_numpy(np.random.RandomState(seed)
                            .randint(0, 2**32, (n, 2), dtype=np.int64))


def test_sample_token_matches_oracle_distribution():
    rng = np.random.RandomState(4)
    logits = rng.randn(8).astype(np.float32)
    params = SamplingParams(temperature=1.3, top_k=5, top_p=0.85, seed=0)
    p = oracle_probs(logits, params)
    B = N_DRAWS
    toks = tsops.sample_token(
        torch.from_numpy(np.tile(logits, (B, 1))),
        torch.full((B,), params.temperature),
        torch.full((B,), params.top_k, dtype=torch.int32),
        torch.full((B,), params.top_p), _draw_keys(),
        torch.zeros(B, dtype=torch.int32)).numpy()
    stat, dof = _chi2(np.bincount(toks, minlength=8), p, B)
    assert stat < _chi2_crit(dof)


def test_rejection_sampling_preserves_target_distribution():
    """With a deterministic draft d, the emitted marginal `accept ? d :
    resample` is p, for a mid-probability d, the argmax and a masked d;
    the bonus row is a plain draw from p."""
    rng = np.random.RandomState(3)
    logits = rng.randn(8).astype(np.float32) * 1.5
    params = SamplingParams(temperature=0.8, top_k=6, top_p=0.92, seed=0)
    p = oracle_probs(logits, params)
    order = np.argsort(-p)
    B = N_DRAWS
    lg = torch.from_numpy(np.tile(logits, (B, 2, 1)))
    args = (torch.full((B,), params.temperature),
            torch.full((B,), params.top_k, dtype=torch.int32),
            torch.full((B,), params.top_p), _draw_keys(seed=7),
            torch.zeros(B, dtype=torch.int32))
    for d in (int(order[2]), int(order[0]), int(order[-1])):
        tokens = torch.from_numpy(np.stack([np.zeros(B), np.full(B, d)], 1)
                                  .astype(np.int32))
        choices, accepts = tsops.verify_window(
            lg, tokens, torch.ones(B, dtype=torch.int32), *args)
        choices, accepts = choices.numpy(), accepts.numpy()
        emitted = np.where(accepts[:, 0], d, choices[:, 0])
        if p[d] == 0:
            assert not accepts[:, 0].any()
        stat, dof = _chi2(np.bincount(emitted, minlength=8), p, B)
        assert stat < _chi2_crit(dof), (d, stat, dof)
        stat, dof = _chi2(np.bincount(choices[:, 1], minlength=8), p, B)
        assert stat < _chi2_crit(dof)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
_PROMPTS = [(9, 12), (17, 10), (5, 12), (20, 8), (3, 14)]
SAMPLED = dict(temperature=0.9, top_k=20, top_p=0.95)


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


def _trace(seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, VOCAB, plen).astype(np.int32), n)
            for plen, n in _PROMPTS]


def _mixed(i):
    """Lanes 1, 2 and 4 sample (two temperatures, seeds 100 + i); 0 and 3
    are greedy."""
    if i in (1, 2, 4):
        return dict(SAMPLED, temperature=0.7 if i == 2 else 1.0,
                    seed=100 + i)
    return None


def _serve(eng, trace, params_of, cls):
    ids = []
    for i, (p, n) in enumerate(trace):
        kw = params_of(i)
        ids.append(eng.add_request(
            p, n, sampling_params=None if kw is None else cls(**kw)))
        if i == 2:
            eng.step()                   # mid-run arrivals
    out = eng.run()
    return [list(map(int, out[r])) for r in ids]


def _port(models, **kw):
    return GenerationEngine(models[1], device="cpu", num_slots=3,
                            block_size=8, **kw)


@pytest.mark.parametrize("K", [0, 4])
def test_sampled_engine_token_identical_to_jax(models, no_switches, K):
    jm, _ = models
    jeng = JEngine(jm, num_slots=3, block_size=8, attention_backend="dense",
                   sampling=True, spec_decode_k=K)
    want = _serve(jeng, _trace(), _mixed, JParams)
    teng = _port(models, sampling=True, spec_decode_k=K)
    got = _serve(teng, _trace(), _mixed, SamplingParams)
    assert got == want
    assert teng.sampled_tokens == sum(
        len(o) - len(p) for i, (o, (p, _)) in enumerate(zip(got, _trace()))
        if _mixed(i) is not None)
    if K:
        assert teng.spec_accepted_tokens > 0


@pytest.mark.parametrize("K", [0, 4])
def test_greedy_lanes_bit_exact_to_sampling_off(models, no_switches, K):
    """On a sampling engine, greedy lanes (no params, temperature 0) emit
    what a `sampling=False` engine emits, beside sampled lanes or not."""
    plain = _serve(_port(models, spec_decode_k=K), _trace(),
                   lambda i: None, SamplingParams)
    zero = _serve(_port(models, sampling=True, spec_decode_k=K), _trace(),
                  lambda i: dict(temperature=0.0, top_k=3, seed=i),
                  SamplingParams)
    mixed = _serve(_port(models, sampling=True, spec_decode_k=K), _trace(),
                   _mixed, SamplingParams)
    assert zero == plain
    assert [m for i, m in enumerate(mixed) if _mixed(i) is None] == \
        [p for i, p in enumerate(plain) if _mixed(i) is None]
    assert mixed != plain


def test_sampled_streams_reproduce_and_warm_cache_replays(models,
                                                          no_switches):
    """Same (seed, trace, config) gives the same tokens; the same engine
    serving the trace again from its prefix cache replays them (keys are
    position-pure); a K=4 engine replays itself."""
    params = lambda i: dict(SAMPLED, seed=50 + i)
    base = _serve(_port(models, sampling=True), _trace(), params,
                  SamplingParams)
    eng = _port(models, sampling=True)
    assert _serve(eng, _trace(), params, SamplingParams) == base
    assert _serve(eng, _trace(), params, SamplingParams) == base
    assert eng.prefix_hit_tokens > 0
    spec = [_serve(_port(models, sampling=True, spec_decode_k=4), _trace(),
                   params, SamplingParams) for _ in range(2)]
    assert spec[0] == spec[1]


def test_none_seed_resolves_deterministically(models, no_switches):
    p = lambda i: dict(temperature=1.0)
    one = _serve(_port(models, sampling=True), _trace(), p, SamplingParams)
    two = _serve(_port(models, sampling=True), _trace(), p, SamplingParams)
    assert one == two
    eng = _port(models, sampling=True)
    eng.add_request([1, 2], 2, sampling_params=SamplingParams())
    eng.add_request([1, 2], 2, sampling_params=SamplingParams(seed=9))
    eng.add_request([1, 2], 2, sampling_params=SamplingParams())
    assert [r.sampling.seed for r in eng._queues["standard"]] == [0, 9, 1]


def test_best_of_n_shares_prompt_blocks_once(models, no_switches):
    eng = _port(models, sampling=True, num_blocks=40)
    prompt = _trace()[1][0]              # 17 tokens: 2 full blocks
    params = SamplingParams(temperature=1.0, seed=5)
    cands = eng.best_of_n(prompt, 3, 10, sampling_params=params)
    assert len(cands) == 3 and len({tuple(c) for c in cands}) > 1
    plen = len(prompt)
    shared = (plen // 8) * 8
    for c in cands:
        assert c[:plen] == list(map(int, prompt))
    assert eng.prefix_hit_tokens == 2 * shared
    assert len(eng.cache._hash_of) == plen // 8
    assert _port(models, sampling=True).best_of_n(
        prompt, 3, 10, sampling_params=params) == cands
    # against the JAX engine's candidates
    jeng = JEngine(models[0], num_slots=3, block_size=8,
                   attention_backend="dense", sampling=True)
    assert [list(map(int, c)) for c in jeng.best_of_n(
        prompt, 3, 10, sampling_params=JParams(temperature=1.0,
                                               seed=5))] == cands
    with pytest.raises(ValueError, match="temperature > 0"):
        eng.best_of_n(prompt, 2, 4,
                      sampling_params=SamplingParams(temperature=0))
    eng3 = _port(models, sampling=True)
    eng3.best_of_n(prompt, 2, 2,
                   sampling_params=SamplingParams(temperature=1.0))
    assert eng3._seed_counter == 2
    eng4 = GenerationEngine(models[1], device="cpu", num_slots=1,
                            block_size=8, sampling=True, max_queue=1)
    with pytest.raises(RuntimeError, match="shed"):
        eng4.best_of_n(prompt, 4, 2, sampling_params=SamplingParams(
            temperature=1.0, seed=3))


def test_sampling_params_validation(models, no_switches):
    with pytest.raises(ValueError, match="temperature"):
        SamplingParams(temperature=-0.5)
    with pytest.raises(ValueError, match="top_k"):
        SamplingParams(top_k=-1)
    with pytest.raises(ValueError, match="top_p"):
        SamplingParams(top_p=0.0)
    with pytest.raises(ValueError, match="top_p"):
        SamplingParams(top_p=1.5)
    with pytest.raises(ValueError, match="seed"):
        SamplingParams(seed=1.5)
    eng = _port(models)
    with pytest.raises(ValueError, match="sampling=True"):
        eng.add_request([1, 2, 3], 2, sampling_params=SamplingParams())
    with pytest.raises(TypeError, match="SamplingParams"):
        _port(models, sampling=True).add_request(
            [1, 2, 3], 2, sampling_params={"temperature": 1.0})
    with pytest.raises(ValueError, match="sampling=True"):
        eng.best_of_n([1, 2, 3], 2, 4)
    with pytest.raises(ValueError, match="prefix cache"):
        _port(models, sampling=True, enable_prefix_cache=False).best_of_n(
            [1, 2, 3], 2, 4)
    with pytest.raises(ValueError, match="n >= 1"):
        _port(models, sampling=True).best_of_n([1, 2, 3], 0, 4)


def test_env_override_enables_sampling(models, no_switches):
    no_switches.setenv("PADDLE_SERVE_SAMPLING", "1")
    assert _port(models).sampling is True
    no_switches.setenv("PADDLE_SERVE_SAMPLING", "0")
    assert _port(models, sampling=True).sampling is False
    no_switches.setenv("PADDLE_SERVE_SAMPLING", "maybe")
    with pytest.raises(ValueError, match="PADDLE_SERVE_SAMPLING"):
        _port(models)


def test_sampled_tokens_counts_only_sampled_lanes(models, no_switches):
    trace = _trace()
    eng = _port(models, sampling=True)
    outs = _serve(eng, trace, lambda i: dict(SAMPLED, seed=1)
                  if i == 1 else None, SamplingParams)
    assert eng.sampled_tokens == len(outs[1]) - len(trace[1][0])
    plain = _port(models)
    _serve(plain, trace, lambda i: None, SamplingParams)
    assert plain.sampled_tokens == 0


def test_sampling_params_copied_from_jax():
    """The port's SamplingParams is JAX's: fields, defaults, `greedy` and
    `with_seed`."""
    fields = [(f.name, f.default) for f in dataclasses.fields(JParams)]
    assert [(f.name, f.default)
            for f in dataclasses.fields(SamplingParams)] == fields
    p = SamplingParams(temperature=0.5, top_k=3)
    assert not p.greedy and SamplingParams(temperature=0).greedy
    assert p.with_seed(4) == SamplingParams(temperature=0.5, top_k=3,
                                            seed=4)
    rng = np.random.RandomState(9)
    lg = rng.randn(40).astype(np.float32)
    from paddle_tpu.inference.sampling import oracle_probs as j_oracle
    for kw in (dict(temperature=0.8, top_k=7, top_p=0.9), dict(),
               dict(temperature=0.0)):
        np.testing.assert_array_equal(oracle_probs(lg, SamplingParams(**kw)),
                                      j_oracle(lg, JParams(**kw)))


# -- the draw kernel's split of a row over a cluster -------------------------
# (`csrc/sampling.cu` `sample_draw_kernel`: rank c of a row's cluster walks
# the share [c vs, (c + 1) vs) of the vocabulary; each CTA joins its 256
# threads by shuffles and its 8 warps in shared memory, and rank 0 joins the
# C partials in rank order. The join below repeats that tree in numpy.)
_INT_MAX = 0x7FFFFFFF


def _draw_shares(V, cluster):
    """`[(begin, end)]` of each rank's share, as the kernel's `vs` cuts V:
    ceil(V / C) rounded up to 4 a rank, the last ones to V."""
    vs = (-(-V // cluster) + 3) // 4 * 4
    return [(min(V, c * vs), min(V, (c + 1) * vs)) for c in range(cluster)]


def _beats(bv, bi, av, ai):
    """The kernel's `beats`: larger value, lower index on a tie, NaN
    first."""
    bn, an = np.isnan(bv), np.isnan(av)
    if bn or an:
        return bool(bn and (not an or bi < ai))
    return bool(bv > av or (bv == av and bi < ai))


def _butterfly(vals, idxs):
    """A xor butterfly over 32 lanes, as `warp_best`: every lane ends with
    the best pair."""
    vals, idxs = list(vals), list(idxs)
    off = 16
    while off:
        nv, ni = vals[:], idxs[:]
        for lane in range(32):
            o = lane ^ off
            if _beats(vals[o], idxs[o], vals[lane], idxs[lane]):
                nv[lane], ni[lane] = vals[o], idxs[o]
        vals, idxs = nv, ni
        off //= 2
    return vals[0], idxs[0]


def _cta_best(val, b, e, skew):
    """One CTA's best of the entries [b, e) of `val`: thread t takes the
    fours t, t + 256, ... from the first 16-byte boundary (`skew` entries
    past one at b), threads 0-3 the entries before it and 4-7 those after
    the last whole four; then its warps and its CTA."""
    vb = min(e, b + ((4 - skew) & 3))
    n4 = (e - vb) // 4
    vt = vb + 4 * n4
    best = [-np.inf] * 256
    arg = [_INT_MAX] * 256

    def take(t, v):
        if _beats(val[v], v, best[t], arg[t]):
            best[t], arg[t] = val[v], v

    for i in range(n4):
        for k in range(4):
            take(i % 256, vb + 4 * i + k)
    for t in range(8):
        v = b + t if t < 4 else vt + t - 4
        if v < (vb if t < 4 else e):
            take(t, v)
    warps = [_butterfly(best[w * 32:(w + 1) * 32], arg[w * 32:(w + 1) * 32])
             for w in range(8)]
    pad = [(-np.inf, _INT_MAX)] * 24
    return _butterfly([w[0] for w in warps + pad],
                      [w[1] for w in warps + pad])


def _emulate_draw(g, lg, skip, cluster, row_skew=0):
    """The kernel's token from Gumbels `g` and logits `lg` (fp32 `[V]`),
    `skip` excluded: each rank's CTA best, joined in rank order."""
    val = (g + np.where(np.arange(lg.size) == skip, np.float32(-np.inf),
                        lg)).astype(np.float32)
    best, arg = -np.inf, _INT_MAX
    for c, (b, e) in enumerate(_draw_shares(lg.size, cluster)):
        v, i = _cta_best(val, b, e, (row_skew + b) % 4)
        if c == 0 or _beats(v, i, best, arg):
            best, arg = v, i
    return arg


def test_draw_cluster_from_n_alone():
    """About two CTAs an SM over the rows, a power of two from 1 to 16: 16
    at the decode step's N 8, 8 at the verify step's N 40, 1 at 4,096."""
    cs = [tsops._draw_cluster(n) for n in range(1, 600)]
    assert all(1 <= c <= 16 and c & (c - 1) == 0 for c in cs)
    assert all(a >= b for a, b in zip(cs, cs[1:]))
    assert (tsops._draw_cluster(8), tsops._draw_cluster(40),
            tsops._draw_cluster(4096)) == (16, 8, 1)


@pytest.mark.parametrize("V", [1, 5, 333, 1003, 50257, 50304])
@pytest.mark.parametrize("cluster", [1, 2, 8, 16])
def test_draw_shares_cover_the_vocabulary(V, cluster):
    """Each rank's share is whole fours but the last that holds entries;
    together they are V, in rank order; the kernel cuts by one formula."""
    shares = _draw_shares(V, cluster)
    assert shares[0][0] == 0 and shares[-1][1] == V
    for (b0, e0), (b1, _) in zip(shares, shares[1:]):
        assert e0 == b1
    held = [(b, e) for b, e in shares if e > b]
    assert all((e - b) % 4 == 0 and b % 4 == 0 for b, e in held[:-1])
    text = (Path(CSRC) / "sampling.cu").read_text()
    assert "const int vs = ((V + cluster - 1) / cluster + 3) / 4 * 4;" in text


def _ref_token(g, lg, skip):
    col = torch.arange(lg.size)
    t = torch.where(col == skip, -torch.inf, torch.from_numpy(lg)) + \
        torch.from_numpy(g)
    return int(torch.argmax(t))


@pytest.mark.parametrize("cluster", [1, 2, 8, 16])
@pytest.mark.parametrize("row_skew", [0, 1, 3])
@pytest.mark.parametrize("case", ["tie_across_boundary", "nan",
                                  "excluded_at_boundary", "all_masked",
                                  "random"])
def test_cluster_join_is_torch_argmax(cluster, row_skew, case):
    """The kernel's join (threads, warps, CTAs in rank order) over a row
    split into `cluster` shares gives torch.argmax's index: a tie that
    straddles a share boundary takes the lower index, a NaN wins over
    every number (the first NaN), an excluded index at a boundary loses,
    an all -inf row draws 0."""
    V = 1003
    rng = np.random.default_rng(cluster * 10 + row_skew)
    g = rng.gumbel(size=V).astype(np.float32)
    lg = (rng.standard_normal(V) * 3).astype(np.float32)
    skip = -1
    bounds = [b for b, e in _draw_shares(V, max(cluster, 2))[1:] if b < V]
    edge = bounds[0]
    if case == "tie_across_boundary":
        g[edge - 1] = g[edge] = 0.0
        lg[edge - 1] = lg[edge] = 50.0
    elif case == "nan":
        lg[edge + 1] = np.nan
        lg[edge - 2] = np.nan
        lg[3] = 80.0
    elif case == "excluded_at_boundary":
        g[edge] = 0.0
        lg[edge] = 90.0
        skip = edge
    elif case == "all_masked":
        lg[:] = -np.inf
    got = _emulate_draw(g, lg, skip, cluster, row_skew)
    assert got == _ref_token(g, lg, skip)
    if case == "tie_across_boundary":
        assert got == edge - 1
    elif case == "nan":
        assert got == edge - 2
    elif case == "excluded_at_boundary":
        assert got != edge
    elif case == "all_masked":
        assert got == 0
