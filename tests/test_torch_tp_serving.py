"""Tensor-parallel serving of the port against its mp=1 engine and the JAX
engine at the same mp.

JAX's own model and trace (tests/test_engine_sharded.py: vocab 64, hidden
32, 2 layers, 4 heads, seq 64, `_mixed_trace`): the port's weights come from
the JAX model through the weight bridge, its engines run f32 on a virtual
mesh of the CPU (`["cpu"] * mp`, the counterpart of JAX's forced host
devices) and the JAX engines on JAX's virtual mesh with the dense backend.
The port at mp 2 and 4 must equal the port at mp 1 and the JAX engine at the
same mp token for token: chunked cold and warm and bucketed prefill, K 0 and
4, eviction under pool pressure, int8 KV and weights (the folded scales
bitwise mp=1's), adapters with int8 weights, sampled lanes. The per-shard
weights (fp and int8) are JAX's `_build_tp_state` shards bit for bit.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.adapters import AdapterRegistry as JRegistry
from paddle_tpu.adapters import PagedAdapterPool as JPool
from paddle_tpu.distributed import serving_mesh as j_serving_mesh
from paddle_tpu.inference import GenerationEngine as JEngine
from paddle_tpu.inference import SamplingParams as JParams
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu_torch import (GenerationEngine, GPTConfig, GPTForCausalLM,
                              PagedKVCache, load_paddle_tpu_state)
from paddle_tpu_torch.adapters import AdapterRegistry, PagedAdapterPool
from paddle_tpu_torch.distributed import ServingMesh, serving_mesh
from paddle_tpu_torch.inference import SamplingParams

VOCAB = 64          # divisible by mp in {2, 4}
SWITCHES = ("PADDLE_SPEC_DECODE_K", "PADDLE_SERVE_KV_DTYPE",
            "PADDLE_SERVE_WEIGHT_DTYPE", "PADDLE_SERVE_SAMPLING",
            "PADDLE_PAGED_ATTENTION_BACKEND", "PADDLE_SERVE_MP")


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
    for var in SWITCHES:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def _raised(fn):
    """(exception type, message) of what `fn()` raised, or None."""
    try:
        fn()
    except Exception as e:                      # noqa: BLE001
        return type(e), str(e)
    return None


# copied from tests/test_engine_sharded.py
def _mixed_trace(rng, n=4):
    """Mixed lengths + a hot shared prefix + a block-aligned
    full-prefix hit (block_size 4)."""
    reqs = [(rng.randint(0, VOCAB, rng.randint(2, 13)).astype(np.int32),
             int(rng.randint(2, 7))) for _ in range(n)]
    shared = rng.randint(0, VOCAB, 8).astype(np.int32)
    reqs += [(np.concatenate([shared, rng.randint(0, VOCAB, 3)])
              .astype(np.int32), 4),
             (shared.copy(), 4)]
    return reqs


def _run_trace(eng, reqs, midrun=True, **add):
    ids = [eng.add_request(p, n, **add) for p, n in reqs[:len(reqs) // 2]]
    if midrun:
        for _ in range(2):
            eng.step()                 # admissions land mid-decode
    ids += [eng.add_request(p, n, **add) for p, n in reqs[len(reqs) // 2:]]
    out = eng.run()
    return [list(map(int, out[rid])) for rid in ids]


def _gathered(cache):
    """A head-sharded cache's K and V pools put back together on heads."""
    return (torch.cat(cache.kpools, dim=3), torch.cat(cache.vpools, dim=3))


def _engine(models, pkg, mp, **kw):
    jm, tm = models
    if pkg == "jax":
        return JEngine(jm, attention_backend="dense", mp_degree=mp, **kw)
    return GenerationEngine(tm, device="cpu", mp_degree=mp, **kw)


def _matrix(models, pkg, mp, K):
    """JAX's parity matrix: chunked cold, the same engine warm, bucketed."""
    reqs = _mixed_trace(np.random.RandomState(11))
    kw = dict(num_slots=3, block_size=4, num_blocks=64, spec_decode_k=K)
    eng = _engine(models, pkg, mp, prefill_chunk=8, **kw)
    cold = _run_trace(eng, reqs)
    warm = _run_trace(eng, reqs, midrun=False)
    eng_b = _engine(models, pkg, mp, prefill_buckets=(16, 64), **kw)
    bucketed = _run_trace(eng_b, reqs)
    assert eng.prefix_hit_tokens > 0
    return (cold, warm, bucketed), eng, eng_b


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("K", [0, 4])
def test_tp_token_identical_to_mp1_and_jax(models, no_switches, mp, K):
    ref, eng1, _ = _matrix(models, "torch", 1, K)
    got, eng, eng_b = _matrix(models, "torch", mp, K)
    want, _, _ = _matrix(models, "jax", mp, K)
    assert got == ref == want
    assert eng.mp_degree == mp and eng.mesh.shape == {"mp": mp}
    for e in (eng, eng_b):
        c = e.cache
        assert len(c.kpools) == mp and c.pool_spec() == eng1.cache.pool_spec()
        assert all(tuple(p.shape) == c.shard_spec()[0]
                   and p.shape[3] == 4 // mp for p in c.kpools + c.vpools)
        assert e.cache.leak_check() == []
    # the head-sharded pools are mp=1's planes, split on heads
    k, v = _gathered(eng.cache)
    assert torch.equal(k, eng1.cache.kpool)
    assert torch.equal(v, eng1.cache.vpool)
    assert eng.cache.pool_nbytes() == eng1.cache.pool_nbytes()


@pytest.mark.parametrize("mp", [2, 4])
def test_tp_eviction_under_pressure(models, no_switches, mp):
    """A pool of 9 blocks for 3 lanes: lanes stall and prefix-cached
    blocks are evicted (the warm pass hits less than in a roomy pool), the
    same way at every mp and in JAX."""
    reqs = _mixed_trace(np.random.RandomState(5), n=6)

    def serve(pkg, m, blocks=9):
        eng = _engine(models, pkg, m, num_slots=3, block_size=4,
                      num_blocks=blocks, prefill_chunk=8)
        return _run_trace(eng, reqs) + _run_trace(eng, reqs[::-1]), eng

    ref, eng1 = serve("torch", 1)
    got, eng = serve("torch", mp)
    want, _ = serve("jax", mp)
    assert got == ref == want
    assert eng.stalls == eng1.stalls and sum(eng.stalls.values()) > 0
    assert eng.prefix_hit_tokens < serve("torch", mp, 64)[1].prefix_hit_tokens
    assert eng.cache.leak_check() == []


@pytest.mark.parametrize("mp", [2, 4])
def test_tp_int8_kv_and_weights(models, no_switches, mp):
    """int8 pools and weights, chunked at K 4 and bucketed at K 0: the
    tokens of mp=1 and of JAX, and the per-block grids bitwise mp=1's (each
    write folds the shards' absmax)."""
    reqs = _mixed_trace(np.random.RandomState(2))
    kw = dict(num_slots=3, block_size=4, num_blocks=64, kv_dtype="int8",
              weight_dtype="int8")
    for strategy in (dict(prefill_chunk=8, spec_decode_k=4),
                     dict(prefill_buckets=(16, 64))):
        outs, engs = {}, {}
        for key, pkg, m in (("ref", "torch", 1), ("got", "torch", mp),
                            ("want", "jax", mp)):
            engs[key] = _engine(models, pkg, m, **kw, **strategy)
            outs[key] = _run_trace(engs[key], reqs)
        assert outs["got"] == outs["ref"] == outs["want"]
        c, c1 = engs["got"].cache, engs["ref"].cache
        assert all(p.dtype == torch.int8 for p in c.kpools)
        assert torch.equal(c.scales, c1.scales)
        k, v = _gathered(c)
        assert torch.equal(k, c1.kpool) and torch.equal(v, c1.vpool)


def _adapter_regs(cfg):
    """Adapters 1 and 2 in both packages' registries (strong factors)."""
    regs = (JRegistry(cfg, max_rank=4), AdapterRegistry(cfg, max_rank=4))
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    for aid, r in ((1, 2), (2, 3)):
        rng = np.random.RandomState(7 + aid)
        w = {site: [(rng.randn(r, i).astype(np.float32) * 0.3,
                     rng.randn(o, r).astype(np.float32) * 0.3)
                    for _ in range(L)]
             for site, (i, o) in (("qkv", (H, 3 * H)), ("out", (H, H)),
                                  ("fc1", (H, I)), ("fc2", (I, H)))}
        for reg in regs:
            reg.register(aid, w, scaling=0.5)
    return regs


def test_tp_adapters_compose_with_int8_weights(models, no_switches):
    """JAX's `test_mp2_and_int8_weights_compose`
    (tests/test_engine_lora.py:220) in both packages: adapters under the
    mp=2 engine (column-sharded B pages) equal mp=1 and JAX's mp=2; with
    int8 base weights too; mixed tenants equal a dedicated engine."""
    jreg, treg = _adapter_regs(models[1].config)
    rng = np.random.RandomState(3)
    reqs = [(rng.randint(0, VOCAB, rng.randint(3, 12)).astype(np.int32),
             int(rng.randint(3, 7)), a) for a in (0, 1, 2, 1, 0, 2)]

    def serve(pkg, mp, subset=None, **kw):
        eng = _engine(models, pkg, mp, num_slots=2, block_size=4,
                      num_blocks=64, prefill_chunk=8,
                      adapters=jreg if pkg == "jax" else treg, **kw)
        ids = [eng.add_request(p, n, adapter_id=a)
               for p, n, a in (subset or reqs)]
        out = eng.run()
        return [list(map(int, out[i])) for i in ids], eng

    got, eng = serve("torch", 2)
    assert got == serve("torch", 1)[0] == serve("jax", 2)[0]
    assert eng.adapter_pool.mesh == eng.mesh
    assert got != serve("torch", 2, subset=[(p, n, 0) for p, n, _ in reqs])[0]
    q_mixed, _ = serve("torch", 2, weight_dtype="int8")
    assert q_mixed == serve("jax", 2, weight_dtype="int8")[0] \
        == serve("torch", 1, weight_dtype="int8")[0]
    only1 = [(i, r) for i, r in enumerate(reqs) if r[2] == 1]
    alone, _ = serve("torch", 2, subset=[r for _, r in only1],
                     weight_dtype="int8")
    assert alone == [q_mixed[i] for i, _ in only1]


def test_tp_adapter_pool_shards_the_b_pages(models):
    """The B stacks split on `shard_axis` (one contiguous tensor a shard),
    the A stacks and scalings one tensor on the CPU; a swap-in writes each
    shard's slice of the registry's pages."""
    _, treg = _adapter_regs(models[1].config)
    whole = PagedAdapterPool(treg, num_pages=3, device="cpu")
    pool = PagedAdapterPool(treg, num_pages=3,
                            mesh=serving_mesh(2, devices=["cpu"] * 2))
    assert whole.acquire(2) == pool.acquire(2) == 1
    spec = pool.adapter_pool_spec()
    for i, (name, (_, _, axis)) in enumerate(spec.items()):
        shards = [pool.arrays(r)[i] for r in range(2)]
        if axis is None:
            assert shards[0] is shards[1]
            assert torch.equal(shards[0], whole.arrays()[i])
        else:
            assert all(s.is_contiguous() for s in shards)
            assert torch.equal(torch.cat(shards, dim=axis),
                               whole.arrays()[i]), name
    assert pool.pool_nbytes() == whole.pool_nbytes()


def test_tp_sampled_lanes(models, no_switches):
    """Sampled lanes at mp=2 draw on the gathered logits: the mp=1 streams
    and JAX's mp=2 streams, K 0 and 4."""
    reqs = _mixed_trace(np.random.RandomState(4))
    for K in (0, 4):
        outs = []
        for pkg, mp in (("torch", 1), ("torch", 2), ("jax", 2)):
            P = JParams if pkg == "jax" else SamplingParams
            eng = _engine(models, pkg, mp, num_slots=3, block_size=4,
                          num_blocks=64, prefill_chunk=8, spec_decode_k=K,
                          sampling=True)
            ids = [eng.add_request(
                p, n, sampling_params=None if i % 3 == 0 else P(
                    temperature=0.8, top_k=20, seed=100 + i))
                for i, (p, n) in enumerate(reqs)]
            out = eng.run()
            outs.append([list(map(int, out[r])) for r in ids])
        assert outs[0] == outs[1] == outs[2]


@pytest.mark.parametrize("kw", [dict(num_heads=4), dict(vocab_size=63),
                                dict(), dict(num_heads=6, vocab_size=64)])
@pytest.mark.parametrize("mp", [0, 2, 3, 4])
def test_serving_mesh_checks_as_jax(kw, mp):
    """The same ValueErrors and texts as JAX's `serving_mesh`."""
    devices = ["cpu"] * 8
    got = _raised(lambda: serving_mesh(mp, devices=devices, **kw))
    want = _raised(lambda: j_serving_mesh(mp, **kw))
    assert got == want
    if got is None:
        mesh = serving_mesh(mp, devices=devices, **kw)
        assert mesh.shape == {"mp": mp} and mesh.axis_names == ("mp",)


def test_serving_mesh_devices(monkeypatch):
    mesh = serving_mesh(2, devices=["cpu"] * 2)
    assert mesh.devices == (torch.device("cpu"),) * 2
    assert mesh.distinct == (torch.device("cpu"),)
    assert mesh == ServingMesh(["cpu", "cpu"])
    assert serving_mesh(2, devices=["cpu"] * 3).shape == {"mp": 2}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="needs 2 devices, have 0"):
        serving_mesh(2)
    import paddle_tpu_torch

    assert paddle_tpu_torch.distributed.serving_mesh is serving_mesh


def test_kv_pools_shard_on_heads():
    """`pool_spec()` stays the logical whole (JAX's
    `test_pool_spec_is_the_single_source_of_truth`); each shard holds its
    heads; a head count the mesh does not divide raises."""
    plain = PagedKVCache(2, 8, 4, 4, 8, device="cpu")
    shard = PagedKVCache(2, 8, 4, 4, 8, kv_dtype="int8",
                         mesh=serving_mesh(2, devices=["cpu"] * 2))
    assert plain.pool_spec()[0] == shard.pool_spec()[0] == (2, 8, 4, 4, 8)
    assert shard.shard_spec() == ((2, 8, 4, 2, 8), torch.int8)
    assert [tuple(p.shape) for p in shard.vpools] == [(2, 8, 4, 2, 8)] * 2
    assert shard.scale_shards[0] is shard.scale_shards[1] is shard.scales
    with pytest.raises(AttributeError, match="kpools"):
        shard.kpool
    with pytest.raises(ValueError, match="num_heads"):
        PagedKVCache(2, 8, 4, 3, 8, mesh=serving_mesh(2, devices=["cpu"] * 2))


def test_adapter_pool_divisibility_as_jax(models):
    jreg, treg = _adapter_regs(models[1].config)
    got = _raised(lambda: PagedAdapterPool(
        treg, num_pages=3, mesh=serving_mesh(3, devices=["cpu"] * 3)))
    want = _raised(lambda: JPool(jreg, num_pages=3,
                                 mesh=j_serving_mesh(3)))
    assert got == want and got[0] is ValueError


def test_env_mp_wins_and_mesh_must_agree(models, no_switches):
    jm, tm = models
    kw = dict(num_slots=2, block_size=4)
    no_switches.setenv("PADDLE_SERVE_MP", "2")
    eng = GenerationEngine(tm, device="cpu", mp_degree=4, **kw)
    assert eng.mp_degree == 2 and len(eng.cache.kpools) == 2
    assert JEngine(jm, mp_degree=4, **kw).mp_degree == 2
    got = _raised(lambda: GenerationEngine(
        tm, device="cpu", mesh=serving_mesh(4, devices=["cpu"] * 4), **kw))
    want = _raised(lambda: JEngine(jm, mesh=j_serving_mesh(4), **kw))
    assert got == want and "drop one of the two" in got[1]
    no_switches.setenv("PADDLE_SERVE_MP", "two")
    assert _raised(lambda: GenerationEngine(tm, device="cpu", **kw)) \
        == _raised(lambda: JEngine(jm, **kw))
    no_switches.delenv("PADDLE_SERVE_MP")
    got = _raised(lambda: GenerationEngine(
        tm, device="cpu", mp_degree=2,
        mesh=serving_mesh(4, devices=["cpu"] * 4), **kw))
    want = _raised(lambda: JEngine(jm, mp_degree=2, mesh=j_serving_mesh(4),
                                   **kw))
    assert got == want
    one = GenerationEngine(tm, device="cpu", mp_degree=1, **kw)
    assert one.mp_degree == 1 and one.mesh is None
    with pytest.raises(ValueError, match="num_heads=4 is not divisible"):
        GenerationEngine(tm, device="cpu", mp_degree=3, **kw)


def test_refresh_weights_reshards(models, no_switches):
    """The mp=2 engine serves its snapshot until `refresh_weights()`, then
    the edited weights: an mp=1 engine's tokens before and after (no
    prefix cache, whose blocks would hold the old weights' KV)."""
    _, tm0 = models
    tm = GPTForCausalLM(tm0.config, device="cpu").eval()
    tm.load_state_dict(tm0.state_dict())
    reqs = _mixed_trace(np.random.RandomState(9))
    kw = dict(device="cpu", num_slots=3, block_size=4, prefill_chunk=8,
              enable_prefix_cache=False)

    def serve(eng):
        return _run_trace(eng, reqs, midrun=False)

    eng = GenerationEngine(tm, mp_degree=2, **kw)
    before = serve(GenerationEngine(tm, **kw))
    with torch.no_grad():
        for blk in tm.gpt.blocks:
            blk.mlp.fc1.weight.mul_(3.0)
            blk.attn.qkv_proj.bias.add_(0.5)
    after = serve(GenerationEngine(tm, **kw))
    assert after != before
    assert serve(eng) == before
    eng.refresh_weights()
    assert serve(eng) == after


def _jax_shards(jeng, arr):
    """Each mesh position's numpy shard of a JAX array (mesh order)."""
    by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    return [by_dev[d] for d in jeng.mesh.devices.reshape(-1)]


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("wdt", [None, "int8"])
def test_tp_state_is_jax_build_tp_state(models, no_switches, mp, wdt):
    """Every shard of the port's snapshot equals the JAX engine's
    `_build_tp_state` shard bit for bit, in JAX's `[in, out]` layout (qkv
    `[H, heads/mp, 3, D]`), int8 codes and scales too; the replicated
    norms and wpe equal JAX's."""
    jm, tm = models
    kw = dict(num_slots=2, block_size=4, mp_degree=mp, weight_dtype=wdt)
    jeng = JEngine(jm, **kw)
    teng = GenerationEngine(tm, device="cpu", **kw)
    tp = teng._tp
    cfg = tm.config
    D = cfg.hidden_size // cfg.num_heads
    names = {id(p): n for n, p in jm.named_parameters()}
    rep = tp.replicas[torch.device("cpu")]
    seen = 0
    for t, arr in zip(jeng._state, jeng._tp_arrays):
        name = names[id(t)]
        parts = name.split(".")
        if name == "gpt.wte.weight":
            mine = [s["wte"] for s in tp.shards]
            kind = "rows"
        elif parts[-2] in ("qkv_proj", "out_proj", "fc1", "fc2"):
            layer = int(parts[2])
            entry = [s["layers"][layer][parts[-2]] for s in tp.shards]
            if parts[-1] == "bias":
                mine, kind = [e[-1] for e in entry], "bias"
            else:
                mine, kind = [e[0] for e in entry], "weight"
        else:
            full = {"gpt.wpe.weight": rep["wpe"],
                    "gpt.ln_f.weight": rep["ln_f"][0],
                    "gpt.ln_f.bias": rep["ln_f"][1]}.get(name)
            if full is None:
                ln = rep[parts[3]][int(parts[2])]
                full = ln[0] if parts[-1] == "weight" else ln[1]
            for s in _jax_shards(jeng, arr):
                np.testing.assert_array_equal(full.numpy(), s)
            continue
        qkv = parts[-2] == "qkv_proj"
        scales = None
        if isinstance(arr, tuple):           # int8: (codes, scales)
            arr, jscales = arr
            scales = zip([e[1] for e in entry], _jax_shards(jeng, jscales))
        for r, (m, j) in enumerate(zip(mine, _jax_shards(jeng, arr))):
            if kind == "weight":
                m = m.reshape(-1, 3, D, m.shape[1]).permute(3, 0, 1, 2) \
                    if qkv else m.t()
            elif kind == "bias" and qkv:
                m = m.reshape(-1, 3, D)
            np.testing.assert_array_equal(m.numpy(), j, err_msg=name)
            seen += 1
        for m, j in scales or ():
            m = m.reshape(1, -1, 3, D) if qkv else m.t()
            np.testing.assert_array_equal(m.numpy(), j, err_msg=name)
            assert m.dtype == torch.float32 and j.dtype == np.float32
    assert seen == mp * (1 + 8 * cfg.num_layers)
    if wdt:
        assert all(e[0].dtype == torch.int8 for s in tp.shards
                   for lay in s["layers"] for e in lay.values())
