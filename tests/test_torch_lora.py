"""Multi-tenant LoRA serving of the PyTorch port against the JAX package,
on the CPU (the contract of tests/test_engine_lora.py, held across the two
packages).

- Ops: `lora_linear_delta` and `lora_qkv_delta` (both layouts) within 1e-6
  of `paddle_tpu/ops/lora.py`'s at f32 on the same pool pages, with 4
  heads and nonzero factors on every site (a wrong qkv permutation passes
  at one head); null-page and rank-padded rows exact zeros;
  `batched_lora`'s plain version adds the delta cast once to a bf16 base.
- The registry and the pool: registration's errors and JAX's messages,
  alpha with mixed ranks, the pool's pages bitwise JAX's after a swap-in,
  the same acquire/release/prefetch sequence giving the same pages,
  swap-ins, evictions and leak audits, rank groups, over-release, and
  `adapter_pool_spec`'s shapes and order.
- The engine: a mixed-tenant trace (with mid-run arrivals and a prompt
  shared across tenants) token-identical to JAX's adapter engine at f32,
  chunked and bucketed, K=0 and K=4; each tenant's tokens equal a
  dedicated engine's; adapter id 0 token-identical to the port's engine
  without adapters; adapters change tokens; a two-page pool that thrashes
  emits the big pool's tokens with JAX's swap-ins and evictions; the
  adapter-salted prefix chain; `drain()`'s page audit; live registration;
  int8 weights with adapters against JAX's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.adapters import AdapterRegistry as JRegistry
from paddle_tpu.adapters import PagedAdapterPool as JPool
from paddle_tpu.adapters import adapter_pool_spec as j_spec
from paddle_tpu.inference import GenerationEngine as JEngine
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.ops.lora import lora_linear_delta as j_linear_delta
from paddle_tpu.ops.lora import lora_qkv_delta as j_qkv_delta
from paddle_tpu_torch import (GenerationEngine, GPTConfig, GPTForCausalLM,
                              load_paddle_tpu_state)
from paddle_tpu_torch.adapters import (NULL_ADAPTER_ID, AdapterRegistry,
                                       PagedAdapterPool, adapter_pool_spec)
from paddle_tpu_torch.inference.engine import prefix_key
from paddle_tpu_torch.ops.lora import (LORA_SITES, batched_lora,
                                       lora_linear_delta, lora_qkv_delta)

VOCAB = 64


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
                "PADDLE_PAGED_ATTENTION_BACKEND", "PADDLE_SERVE_MP"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def _raised(fn):
    """(exception type, message) of what `fn()` raised, or None."""
    try:
        fn()
    except Exception as e:                      # noqa: BLE001
        return type(e), str(e)
    return None


def _weights(cfg, rank, seed, scale=0.3):
    """One adapter's factors on every site and layer, from `seed`."""
    rng = np.random.RandomState(seed)
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    w = {}
    for site, (i_d, o_d) in (("qkv", (H, 3 * H)), ("out", (H, H)),
                             ("fc1", (H, I)), ("fc2", (I, H))):
        w[site] = [(rng.randn(rank, i_d).astype(np.float32) * scale,
                    rng.randn(o_d, rank).astype(np.float32) * scale)
                   for _ in range(L)]
    return w


def _registries(cfg, max_rank=4, ranks=(2, 3), group=None):
    """The same adapters (ids 1..) registered in both packages: strong
    factors, so that every adapter visibly changes greedy streams."""
    regs = (JRegistry(cfg, max_rank=max_rank),
            AdapterRegistry(cfg, max_rank=max_rank))
    for aid, r in enumerate(ranks, start=1):
        w = _weights(cfg, r, seed=7 + aid)
        for reg in regs:
            reg.register(aid, w, scaling=0.5, group=group)
    return regs


@pytest.fixture(scope="module")
def registries(models):
    return _registries(models[1].config)


def _np(a):
    return np.asarray(getattr(a, "_array", a))


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def _pools(cfg, dtype=None):
    """Both packages' pools over the same two adapters, adapter 2 (rank 3
    of max_rank 4: a padded rank row) on its page, then adapter 1."""
    jreg, treg = _registries(cfg)
    jpool = JPool(jreg, num_pages=4)
    tpool = PagedAdapterPool(treg, num_pages=4, dtype=dtype, device="cpu")
    for pool in (jpool, tpool):
        assert pool.acquire(2) == 1 and pool.acquire(1) == 2
    return jpool, tpool


@pytest.mark.parametrize("site,idx", [(s, i) for i, s in
                                      enumerate(LORA_SITES)])
def test_lora_deltas_match_jax(models, site, idx):
    cfg = models[1].config
    jpool, tpool = _pools(cfg)
    ja, tb = jpool.arrays(), tpool.arrays()
    a_i, b_i = 2 * idx, 2 * idx + 1
    in_d = cfg.intermediate_size if site == "fc2" else cfg.hidden_size
    rng = np.random.RandomState(idx)
    x = rng.randn(4, 3, in_d).astype(np.float32)
    rows = np.asarray([2, 0, 1, 2], np.int32)
    t = [torch.from_numpy(rows), tb[8]]
    for layer in range(cfg.num_layers):
        if site == "qkv":
            for head_major in (False, True):
                want = _np(j_qkv_delta(x, ja[a_i], ja[b_i], rows, ja[8],
                                       layer, head_major))
                got = lora_qkv_delta(torch.from_numpy(x), tb[a_i], tb[b_i],
                                     *t, layer, head_major).numpy()
                assert got.shape == want.shape
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
                assert np.abs(want).max() > 1.0
                assert (got[1] == 0).all()          # the null page
        else:
            want = _np(j_linear_delta(x, ja[a_i], ja[b_i], rows, ja[8],
                                      layer))
            got = lora_linear_delta(torch.from_numpy(x), tb[a_i], tb[b_i],
                                    *t, layer).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
            assert np.abs(want).max() > 1.0
            assert (got[1] == 0).all()
    # adapter 2's padded rank row: exact zeros in both factors
    assert (tb[a_i][1, :, 3] == 0).all() and (tb[b_i][1, :, 3] == 0).all()


def test_qkv_delta_is_the_registered_flat_layout(models):
    """The 3-major qkv delta, flattened, is the textbook `x . A^T . B^T *
    scaling` in the [3H] layout the user registered, and the head-major
    one its transpose: a wrong permutation of the head-grouped page
    shows at 4 heads."""
    cfg = models[1].config
    H, L = cfg.hidden_size, cfg.num_layers
    rng = np.random.RandomState(0)
    A = rng.randn(2, H).astype(np.float32)
    Bq = rng.randn(3 * H, 2).astype(np.float32)
    reg = AdapterRegistry(cfg, max_rank=4)
    reg.register(1, {"qkv": [(A, Bq)] * L}, scaling=0.7)
    pool = PagedAdapterPool(reg, num_pages=3, device="cpu")
    page = pool.acquire(1)
    arrs = pool.arrays()
    x = torch.from_numpy(rng.randn(3, 1, H).astype(np.float32))
    rows = torch.tensor([page, 0, page], dtype=torch.int32)
    d = lora_qkv_delta(x, arrs[0], arrs[1], rows, arrs[8], 0, False)
    want = (x[0, 0].double().numpy() @ A.T @ Bq.T) * 0.7
    np.testing.assert_allclose(d[0, 0].reshape(3 * H).numpy(), want,
                               atol=1e-5)
    assert (d[1] == 0).all()
    dm = lora_qkv_delta(x, arrs[0], arrs[1], rows, arrs[8], 0, True)
    assert torch.equal(dm[0, 0], d[0, 0].transpose(0, 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_lora_plain_adds_the_delta_cast_once(models, dtype):
    """`base + delta.to(dtype)` in place: the bf16 delta rounded once, then
    the bf16 sum (JAX's `qkv + delta.astype(bf16)`); page-0 rows keep the
    base; the plain version is counted."""
    cfg = models[1].config
    _, tpool = _pools(cfg, dtype=dtype)
    tb = tpool.arrays()
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(3, 5, cfg.hidden_size)
                         .astype(np.float32)).to(dtype)
    rows = torch.tensor([1, 0, 2], dtype=torch.int32)
    for a, b, out in ((tb[0], tb[1], 3 * cfg.hidden_size),
                      (tb[4], tb[5], cfg.intermediate_size)):
        base = torch.from_numpy(rng.randn(3, 5, out).astype(np.float32)) \
            .to(dtype)
        keep = base.clone()
        if b.dim() == 6:
            delta = lora_qkv_delta(x, a, b, rows, tb[8], 1, False) \
                .reshape(3, 5, -1)
        else:
            delta = lora_linear_delta(x, a, b, rows, tb[8], 1)
        assert delta.dtype == dtype
        calls = batched_lora.plain_calls
        got = batched_lora(base, x, a, b, rows, tb[8], 1)
        assert got is base and batched_lora.plain_calls == calls + 1
        assert torch.equal(got, keep + delta)
        assert torch.equal(got[1], keep[1])


# ---------------------------------------------------------------------------
# registry and pool
# ---------------------------------------------------------------------------

def _register_cases(cfg):
    H, L = cfg.hidden_size, cfg.num_layers
    ok = {"out": [(np.zeros((2, H), np.float32),
                   np.zeros((H, 2), np.float32))] * L}
    return [
        (0, ok, {}),
        (-3, ok, {}),
        (1, {}, {}),
        (1, {"out": [(np.zeros((3, H), np.float32),
                      np.zeros((H, 3), np.float32))] * L}, {}),
        (1, {"out": [(np.zeros((2, H + 1), np.float32),
                      np.zeros((H, 2), np.float32))] * L}, {}),
        (1, {"nope": ok["out"]}, {}),
        (1, {"out": ok["out"][:1]}, {}),
        (1, {"out": [None] * L}, {}),
        (1, ok, {"scaling": 1.0, "alpha": 2.0}),
        (1, {"out": ok["out"],
             "fc1": [(np.ones((1, H), np.float32),
                      np.ones((cfg.intermediate_size, 1), np.float32))] * L},
         {"alpha": 16}),
        (1, ok, {"alpha": 8}),
        (1, ok, {}),
    ]


def test_registry_validates_as_jax(models):
    """Every registration error with JAX's type and message; then the
    same scaling, rank, lookups and re-registration error."""
    cfg = models[1].config
    jreg, treg = JRegistry(cfg, max_rank=2), AdapterRegistry(cfg, max_rank=2)
    for aid, w, kw in _register_cases(cfg):
        got = _raised(lambda: treg.register(aid, w, **kw))
        want = _raised(lambda: jreg.register(aid, w, **kw))
        assert got == want
    assert got is not None and "already registered" in got[1]
    for aid in (0, 1, 2):
        assert treg.has(aid) == jreg.has(aid)
        assert treg.rank_of(aid) == jreg.rank_of(aid) if aid < 2 else True
    assert treg.scaling_of(1) == jreg.scaling_of(1) == 4.0
    assert treg.ids() == jreg.ids() == [1]
    assert _raised(lambda: AdapterRegistry(cfg, max_rank=0)) == \
        _raised(lambda: JRegistry(cfg, max_rank=0))
    assert NULL_ADAPTER_ID == 0


def test_alpha_with_mixed_ranks_is_rejected_as_jax(models):
    cfg = models[1].config
    H = cfg.hidden_size
    w = {"out": [(np.ones((2, H), np.float32),
                  np.ones((H, 2), np.float32))] * cfg.num_layers,
         "fc1": [(np.ones((4, H), np.float32),
                  np.ones((cfg.intermediate_size, 4),
                          np.float32))] * cfg.num_layers}
    jreg, treg = JRegistry(cfg, max_rank=8), AdapterRegistry(cfg, max_rank=8)
    got = _raised(lambda: treg.register(1, w, alpha=16))
    assert got is not None and "mixed ranks" in got[1]
    assert got == _raised(lambda: jreg.register(1, w, alpha=16))
    treg.register(1, w, scaling=2.0)
    assert treg.scaling_of(1) == 2.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_pages_bitwise_jax_after_swapin(models, dtype):
    cfg = models[1].config
    jreg, treg = _registries(cfg)
    jdt = {"float32": np.float32, "bfloat16": __import__(
        "jax").numpy.bfloat16}[dtype]
    jpool = JPool(jreg, num_pages=3, dtype=jdt)
    tpool = PagedAdapterPool(treg, num_pages=3, dtype=getattr(torch, dtype),
                             device="cpu")
    for pool in (jpool, tpool):
        pool.acquire(2)
        pool.acquire(1)
    for (name, (shape, _, axis)), jarr, tarr in zip(
            j_spec(3, cfg.num_layers, 4, cfg.hidden_size,
                   cfg.intermediate_size, cfg.num_heads, np.float32).items(),
            jpool.arrays(), tpool.arrays()):
        assert tuple(tarr.shape) == shape, name
        want = np.asarray(jarr).astype(np.float32)
        assert np.array_equal(tarr.float().numpy(), want), name
    assert tpool.pool_nbytes() == jpool.pool_nbytes()


def _pool_trace(pool):
    """One acquire/release/prefetch sequence over ids 1-3 in a pool of
    three pages: hits, a stall, LRU evictions, a prefetch that warms in
    place. Returns what each call returned and the pool's state."""
    out = []
    for op, aid in (("acquire", 1), ("acquire", 2), ("acquire", 1),
                    ("acquire", 3), ("release", 1), ("release", 1),
                    ("acquire", 3), ("can_acquire", 1), ("prefetch", 1),
                    ("release", 2), ("prefetch", 1), ("acquire", 1),
                    ("release", 3), ("acquire", 2), ("release", 1),
                    ("release", 2), ("page_of", 3), ("prefetch", 3)):
        out.append((op, aid, getattr(pool, op)(aid)))
    out.append((pool.swapins, pool.evictions, pool.num_free,
                pool.num_resident, pool.leak_check(),
                [pool.refcount(p) for p in range(pool.num_pages)]))
    return out


def test_pool_paging_equals_jax(models):
    cfg = models[1].config
    jreg, treg = _registries(cfg, ranks=(2, 3, 1))
    got = _pool_trace(PagedAdapterPool(treg, num_pages=3, device="cpu"))
    assert got == _pool_trace(JPool(jreg, num_pages=3))
    assert got[-1][0] > 0 and got[-1][1] > 0 and got[-1][4] == []


def test_rank_group_shares_one_page_budget_as_jax(models):
    cfg = models[1].config
    jreg, treg = _registries(cfg, ranks=(2, 3, 4), group="tenantA")
    tpool = PagedAdapterPool(treg, num_pages=4, device="cpu")
    jpool = JPool(jreg, num_pages=4)
    assert treg.group_of(1) == "tenantA" and treg.group_ids("tenantA") == \
        [1, 2, 3]
    for pool in (tpool, jpool):
        page = pool.acquire(1)
        assert not pool.can_acquire(2) and pool.acquire(2) is None
        pool.release(1)
        assert pool.acquire(2) == page and pool.page_of(1) is None
        pool.release(2)
        assert pool.prefetch(3) == page and pool.page_of(3) == page
        assert pool.num_resident == 1 and len(pool._free) == 2
        assert pool.leak_check() == []
    assert (tpool.swapins, tpool.evictions) == (jpool.swapins,
                                                jpool.evictions) == (3, 2)
    # the page holds adapter 3's factors, as JAX's does
    for jarr, tarr in zip(jpool.arrays(), tpool.arrays()):
        assert np.array_equal(tarr.numpy(), np.asarray(jarr))


def test_rank_group_leak_audit_flags_a_second_page(models, monkeypatch):
    cfg = models[1].config
    _, treg = _registries(cfg, ranks=(2, 3), group="tenantA")
    pool = PagedAdapterPool(treg, num_pages=3, device="cpu")
    monkeypatch.setattr(pool, "_group_sibling_page", lambda aid: None)
    pool.acquire(1)
    pool.acquire(2)
    pool.release(1)
    pool.release(2)
    assert pool.leak_check()


def test_pool_release_and_over_release_harden(models, registries):
    pool = PagedAdapterPool(registries[1], num_pages=3, device="cpu")
    page = pool.acquire(1)
    assert page != 0 and pool.page_of(1) == page and pool.acquire(1) == page
    pool.release(1)
    pool.release(1)
    assert pool.leak_check() == []
    with pytest.raises(RuntimeError, match="release"):
        pool.release(1)
    assert pool.acquire(0) == 0 and pool.page_of(0) == 0
    pool.release(0)
    with pytest.raises(KeyError):
        pool.acquire(9)
    assert _raised(lambda: PagedAdapterPool(registries[1], num_pages=1,
                                            device="cpu")) == \
        _raised(lambda: JPool(registries[0], num_pages=1))


def test_adapter_pool_spec_is_jax_layout(models, registries):
    pool = PagedAdapterPool(registries[1], num_pages=4, device="cpu")
    spec = pool.adapter_pool_spec()
    assert list(spec) == ["a_qkv", "b_qkv", "a_out", "b_out", "a_fc1",
                          "b_fc1", "a_fc2", "b_fc2", "scaling"]
    want = j_spec(4, 2, 4, 32, 128, 4, np.float32)
    assert {k: (v[0], v[2]) for k, v in adapter_pool_spec(
        4, 2, 4, 32, 128, 4, torch.float32).items()} == \
        {k: (v[0], v[2]) for k, v in want.items()}
    for arr, (shape, dt, _) in zip(pool.arrays(), spec.values()):
        assert tuple(arr.shape) == shape and arr.dtype == dt
    assert spec["scaling"][1] == torch.float32


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _mixed_trace(rng, adapters=(0, 1, 2), n_per=2):
    """Mixed lengths and a base prompt shared across adapters (what the
    prefix salt guards): [(prompt, max_new, adapter id)]."""
    shared = rng.randint(0, VOCAB, 8).astype(np.int32)
    reqs = []
    for aid in adapters:
        for _ in range(n_per):
            reqs.append((rng.randint(0, VOCAB, rng.randint(2, 13))
                         .astype(np.int32), int(rng.randint(2, 6)), aid))
        reqs.append((np.concatenate([shared, rng.randint(0, VOCAB, 3)])
                     .astype(np.int32), 4, aid))
        reqs.append((shared.copy(), 4, aid))
    return reqs


def _serve(eng, reqs, midrun=True):
    ids = [eng.add_request(p, n, adapter_id=a)
           for p, n, a in reqs[:len(reqs) // 2]]
    if midrun:
        for _ in range(2):
            eng.step()                 # admissions land mid-decode
    ids += [eng.add_request(p, n, adapter_id=a)
            for p, n, a in reqs[len(reqs) // 2:]]
    out = eng.run()
    return [list(map(int, out[rid])) for rid in ids]


def _strategy(pmode):
    return dict(prefill_chunk=8) if pmode == "chunked" \
        else dict(prefill_buckets=(16, 64))


@pytest.mark.parametrize("pmode,K", [("chunked", 0), ("bucketed", 0),
                                     ("chunked", 4), ("bucketed", 4)])
def test_mixed_tenants_token_identical_to_jax(models, registries,
                                              no_switches, pmode, K):
    """One engine serving three tenants (the base and two adapters)
    interleaved, with mid-run arrivals, emits JAX's adapter engine's
    tokens; and each tenant's requests alone on a dedicated engine emit
    the same tokens (no cross-slot leakage)."""
    jm, tm = models
    reqs = _mixed_trace(np.random.RandomState(11))
    kw = dict(num_slots=3, block_size=4, num_blocks=64, spec_decode_k=K,
              **_strategy(pmode))
    want = _serve(JEngine(jm, attention_backend="dense",
                          adapters=registries[0], **kw), reqs)
    teng = GenerationEngine(tm, device="cpu", adapters=registries[1], **kw)
    got = _serve(teng, reqs)
    assert got == want
    assert teng.adapter_swapins == 2 and teng.adapter_evictions == 0
    assert teng.adapter_pool.leak_check() == []
    if pmode == "chunked" and K == 0:
        for aid in (0, 1, 2):
            mine = [(i, r) for i, r in enumerate(reqs) if r[2] == aid]
            ded = GenerationEngine(tm, device="cpu", adapters=registries[1],
                                   **kw)
            toks = _serve(ded, [r for _, r in mine], midrun=False)
            assert toks == [got[i] for i, _ in mine]


@pytest.mark.parametrize("pmode,K", [("chunked", 0), ("bucketed", 4)])
def test_null_adapter_token_identical_to_plain_engine(models, registries,
                                                      no_switches, pmode, K):
    _, tm = models
    reqs = [(p, n, 0) for p, n, _ in _mixed_trace(
        np.random.RandomState(5), adapters=(0,), n_per=3)]
    kw = dict(num_slots=2, block_size=4, num_blocks=64, spec_decode_k=K,
              **_strategy(pmode))
    plain = _serve(GenerationEngine(tm, device="cpu", **kw), reqs)
    lora = GenerationEngine(tm, device="cpu", adapters=registries[1], **kw)
    assert _serve(lora, reqs) == plain
    assert lora.adapter_swapins == 0


def test_adapters_actually_change_tokens(models, registries, no_switches):
    _, tm = models
    p = np.arange(1, 9, dtype=np.int32)
    eng = GenerationEngine(tm, device="cpu", num_slots=3, block_size=4,
                           prefill_chunk=8, adapters=registries[1])
    ids = [eng.add_request(p, 6, adapter_id=a) for a in (0, 1, 2)]
    out = eng.run()
    assert out[ids[0]] != out[ids[1]] != out[ids[2]] != out[ids[0]]
    ref = tm.generate(torch.from_numpy(p)[None], max_length=14,
                      use_cache=True)
    assert out[ids[0]] == ref[0].tolist()


def test_eviction_under_a_small_pool_never_changes_tokens(
        models, registries, no_switches):
    """A two-page pool (the null page and ONE tenant page) serving two
    adapters swaps and evicts continuously, admissions stalling on the
    page, and still emits the big pool's tokens, with JAX's swap-ins and
    evictions; drain()'s audit closes."""
    jm, tm = models
    reqs = _mixed_trace(np.random.RandomState(9), adapters=(1, 2), n_per=2)
    kw = dict(num_slots=2, block_size=4, num_blocks=64, prefill_chunk=8)

    def serve(pages):
        eng = GenerationEngine(tm, device="cpu", adapters=registries[1],
                               adapter_pool_pages=pages, **kw)
        out = _serve(eng, reqs, midrun=False)
        eng.drain()
        return out, eng

    big, _ = serve(3)
    small, eng = serve(2)
    assert small == big
    jeng = JEngine(jm, attention_backend="dense", adapters=registries[0],
                   adapter_pool_pages=2, **kw)
    assert _serve(jeng, reqs, midrun=False) == small
    pool = eng.adapter_pool
    assert (pool.swapins, pool.evictions) == (jeng.adapter_pool.swapins,
                                              jeng.adapter_pool.evictions)
    assert pool.evictions > 0 and pool.swapins > pool.evictions
    assert eng.stalls["adapter"] > 0 and pool.leak_check() == []


def test_bucketed_block_stall_burns_no_swapin(models, registries,
                                              no_switches):
    """Bucketed admissions take their blocks first: one that stalls on
    blocks leaves the adapter pool untouched, as JAX's does."""
    jm, tm = models
    rng = np.random.RandomState(2)
    # 18-token prompts take 5 of the 13 usable blocks each, so the third
    # lane's admission stalls on its blocks until a lane finishes
    reqs = [(rng.randint(0, VOCAB, 18).astype(np.int32), 2, aid)
            for aid in (1, 2, 1, 2, 0, 1)]
    kw = dict(num_slots=3, block_size=4, num_blocks=14,
              prefill_buckets=(16, 64), adapter_pool_pages=2)
    teng = GenerationEngine(tm, device="cpu", adapters=registries[1], **kw)
    got = _serve(teng, reqs, midrun=False)
    jeng = JEngine(jm, attention_backend="dense", adapters=registries[0],
                   **kw)
    assert got == _serve(jeng, reqs, midrun=False)
    assert teng.stalls["admit"] > 0
    assert (teng.adapter_swapins, teng.adapter_evictions) == \
        (jeng.adapter_pool.swapins, jeng.adapter_pool.evictions)
    assert teng.adapter_pool.leak_check() == []


def test_prefix_chain_is_adapter_salted(models, registries, no_switches):
    _, tm = models
    p = np.arange(12, dtype=np.int32)
    assert prefix_key(p, 4, 0) == prefix_key(p, 4)
    assert prefix_key(p, 4, 1) != prefix_key(p, 4) != prefix_key(p, 4, 2)
    kw = dict(num_slots=2, block_size=4, num_blocks=64, prefill_chunk=8,
              adapters=registries[1])
    eng = GenerationEngine(tm, device="cpu", **kw)
    rid = eng.add_request(p, 3, adapter_id=1)
    warm1 = eng.run()[rid]
    c = eng.cache
    assert c.warm_prefix_tokens(p, adapter_id=1) == len(p)
    assert c.warm_prefix_tokens(p, adapter_id=2) == 0
    assert c.warm_prefix_tokens(p) == 0
    assert c.warm_prefix_tokens(p, keys=prefix_key(p, 4, 1)) == len(p)
    hit0 = eng.prefix_hit_tokens
    rid = eng.add_request(p, 3, adapter_id=1)
    assert eng.run()[rid] == warm1 and eng.prefix_hit_tokens > hit0
    hit1 = eng.prefix_hit_tokens
    rid = eng.add_request(p, 3, adapter_id=2)
    out2 = eng.run()[rid]
    assert eng.prefix_hit_tokens == hit1 and out2 != warm1
    ded = GenerationEngine(tm, device="cpu", **dict(
        kw, adapters=PagedAdapterPool(registries[1], num_pages=3,
                                      device="cpu")))
    rid = ded.add_request(p, 3, adapter_id=2)
    assert ded.run()[rid] == out2


def test_drain_audits_adapter_pages(models, registries, no_switches):
    _, tm = models
    kw = dict(num_slots=2, block_size=4, prefill_chunk=8,
              adapters=registries[1])
    eng = GenerationEngine(tm, device="cpu", **kw)
    eng.add_request(np.arange(5, dtype=np.int32), 3, adapter_id=1)
    eng.run()
    GenerationEngine(tm, device="cpu", **kw).drain()
    eng.adapter_pool.acquire(2)          # a dropped release
    with pytest.raises(RuntimeError, match="adapter page"):
        eng.drain()


def test_engine_adapter_intake_and_wiring_as_jax(models, registries,
                                                 no_switches):
    """Intake and construction errors with JAX's types and messages; a
    prebuilt pool pages for one engine only; the default pool is 1 +
    num_slots pages in the model's dtype; over a trace that swaps and
    evicts pages, the adapter gauges, counters and tenant-labelled
    TTFT/TPOT counts are JAX's."""
    jm, tm = models
    base = dict(num_slots=1, block_size=4, prefill_chunk=8)
    teng = GenerationEngine(tm, device="cpu", **base)
    jeng = JEngine(jm, attention_backend="dense", **base)
    assert _raised(lambda: teng.add_request([1, 2], 2, adapter_id=1)) == \
        _raised(lambda: jeng.add_request([1, 2], 2, adapter_id=1))
    teng = GenerationEngine(tm, device="cpu", adapters=registries[1], **base)
    jeng = JEngine(jm, attention_backend="dense", adapters=registries[0],
                   **base)
    assert _raised(lambda: teng.add_request([1, 2], 2, adapter_id=9)) == \
        _raised(lambda: jeng.add_request([1, 2], 2, adapter_id=9))
    assert teng.adapter_pool.num_pages == 2
    assert teng.adapter_pool.dtype == tm.gpt.wte.weight.dtype
    assert teng.adapter_page_available(1) and teng.adapter_page_available(0)
    cfg = tm.config
    other = [r(type("C", (), {"num_layers": 1, "hidden_size": 32,
                              "intermediate_size": 128,
                              "num_heads": 4})()) for r in (JRegistry,
                                                             AdapterRegistry)]
    for kw in (dict(adapters=other), dict(adapter_pool_pages=3),
               dict(adapters="reg")):
        jkw = {k: (v[0] if isinstance(v, list) else v)
               for k, v in kw.items()}
        tkw = {k: (v[1] if isinstance(v, list) else v)
               for k, v in kw.items()}
        got = _raised(lambda: GenerationEngine(tm, device="cpu", **base,
                                               **tkw))
        assert got is not None and got == _raised(lambda: JEngine(
            jm, attention_backend="dense", **base, **jkw))
    pool = PagedAdapterPool(registries[1], num_pages=3, device="cpu")
    e1 = GenerationEngine(tm, device="cpu", adapters=pool, **base)
    assert e1.adapter_pool is pool
    with pytest.raises(ValueError, match="another"):
        GenerationEngine(tm, device="cpu", adapters=pool, **base)
    with pytest.raises(ValueError, match="conflicts"):
        GenerationEngine(tm, device="cpu", adapters=pool,
                         adapter_pool_pages=3, **base)
    assert GenerationEngine(tm, device="cpu", adapters=registries[1],
                            **base).adapter_pool is not pool
    rng = np.random.RandomState(9)
    for aid in (1, 2, 1, 0, 2):
        p = rng.randint(0, VOCAB, 5).astype(np.int32)
        for eng in (teng, jeng):
            eng.add_request(p, 3, adapter_id=aid)
    assert teng.run() == {k: list(map(int, v))
                          for k, v in jeng.run().items()}
    got, want = teng.metrics_snapshot(), jeng.metrics_snapshot()
    assert teng.adapter_evictions == 3 and teng.adapter_swapins == 4
    for name in ("engine_adapter_pool_pages",
                 "engine_adapter_pool_used_pages",
                 "engine_adapter_pool_resident",
                 "engine_adapter_swapins_total",
                 "engine_adapter_evictions_total"):
        assert got[name] == want[name], name
    for name in ("engine_adapter_ttft_seconds",
                 "engine_adapter_tpot_seconds"):
        assert {s["labels"]["adapter"]: s["count"]
                for s in got[name]["series"]} == {
            s["labels"]["adapter"]: s["count"]
            for s in want[name]["series"]}, name
    assert "engine_adapter_swapins_total 4" in teng.render_prometheus()
    assert cfg.num_layers == 2


def test_live_registration_token_identical(models, no_switches):
    """A tenant registered after the engine was built (and served) emits
    the tokens of an engine whose registry held it from the start."""
    _, tm = models
    cfg = tm.config
    w1, w2 = _weights(cfg, 2, seed=21), _weights(cfg, 3, seed=22)
    kw = dict(num_slots=2, block_size=4, num_blocks=64, prefill_chunk=8)
    rng = np.random.RandomState(3)
    reqs = [(rng.randint(0, VOCAB, rng.randint(3, 10)).astype(np.int32),
             int(rng.randint(2, 6)), aid) for aid in (0, 2, 1, 2)]
    ref_reg = AdapterRegistry(cfg, max_rank=4)
    ref_reg.register(1, w1, scaling=0.5)
    ref_reg.register(2, w2, scaling=0.5)
    ref = _serve(GenerationEngine(tm, device="cpu", adapters=ref_reg, **kw),
                 reqs, midrun=False)
    live = AdapterRegistry(cfg, max_rank=4)
    live.register(1, w1, scaling=0.5)
    eng = GenerationEngine(tm, device="cpu", adapters=live, **kw)
    warm = [r for r in reqs if r[2] != 2]
    assert _serve(eng, warm, midrun=False) == \
        [t for t, r in zip(ref, reqs) if r[2] != 2]
    with pytest.raises(ValueError, match="is not registered"):
        eng.add_request(reqs[0][0], 2, adapter_id=2)
    live.register(2, w2, scaling=0.5)
    assert _serve(eng, reqs, midrun=False) == ref


def test_int8_weights_with_adapters_token_identical_to_jax(
        models, registries, no_switches):
    """int8 base weights (through `int8_linear`) with fp adapter deltas:
    JAX's tokens, and the mixed engine's tenant-1 tokens a dedicated
    engine's."""
    jm, tm = models
    reqs = _mixed_trace(np.random.RandomState(3), n_per=1)
    kw = dict(num_slots=2, block_size=4, num_blocks=64, prefill_chunk=8,
              weight_dtype="int8")
    want = _serve(JEngine(jm, attention_backend="dense",
                          adapters=registries[0], **kw), reqs, midrun=False)
    got = _serve(GenerationEngine(tm, device="cpu", adapters=registries[1],
                                  **kw), reqs, midrun=False)
    assert got == want
    only1 = [(i, r) for i, r in enumerate(reqs) if r[2] == 1]
    ded = GenerationEngine(tm, device="cpu", adapters=registries[1], **kw)
    assert _serve(ded, [r for _, r in only1], midrun=False) == \
        [got[i] for i, _ in only1]


def test_best_of_n_under_an_adapter(models, registries, no_switches):
    """Every candidate decodes under the adapter: candidate i's tokens are
    a dedicated request's with seed base + i."""
    from paddle_tpu_torch.inference import SamplingParams

    _, tm = models
    kw = dict(num_slots=2, block_size=4, num_blocks=64, prefill_chunk=8,
              sampling=True, adapters=registries[1])
    p = np.arange(3, 11, dtype=np.int32)
    sp = SamplingParams(temperature=0.9, seed=40)
    cands = GenerationEngine(tm, device="cpu", **kw).best_of_n(
        p, 2, 5, sampling_params=sp, adapter_id=2)
    for i, cand in enumerate(cands):
        eng = GenerationEngine(tm, device="cpu", **kw)
        rid = eng.add_request(p, 5, adapter_id=2,
                              sampling_params=sp.with_seed(40 + i))
        assert eng.run()[rid] == cand


def test_pool_defaults_to_the_card_and_raises_without_one(models, registries,
                                                          monkeypatch):
    """Like every entry point of the port, the pool's `device=None` means
    the CUDA card; without one it raises and asks for `device='cpu'`."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedAdapterPool(registries[1])
    assert PagedAdapterPool(registries[1], device="cpu").device.type == "cpu"
