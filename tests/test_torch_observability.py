"""The port's observability tier against the JAX package's.

The same registry operations go to `paddle_tpu.observability` and
`paddle_tpu_torch.observability`: the snapshots are equal as JSON, the
Prometheus text is byte-identical, it parses back the same, and
`merge_snapshots` folds them alike. `aggregate` takes the single-member
path and refuses more members (ROADMAP Queue A 13). `TrainingTelemetry`
under `TrainStep(telemetry=)` makes JAX's observations: one an optimizer
step, one a merge window, none for a window that failed part-way, and its
loss gauge within 1e-6 of JAX's at f32. The port's profiler records the
engine's spans with `timer_only=True` and refuses the device trace.
Importing the tier initializes no CUDA context.
"""
import ast
import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.jit as jjit
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.observability as jobs
import paddle_tpu.profiler as jprof
from paddle_tpu.optimizer import SGD as JSGD
import paddle_tpu_torch.observability as tobs
import paddle_tpu_torch.profiler as tprof
from paddle_tpu_torch import SGD, GenerationEngine, GPTConfig, \
    GPTForCausalLM, TrainStep
from paddle_tpu_torch.ops.nn_ops import mse_loss

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the type and message compare
        return type(e).__name__, str(e)
    return None


# -- the registry, the exposition, the merge ---------------------------------

def _basics(reg):
    c = reg.counter("reqs_total", "Requests.")
    c.inc()
    c.inc(2.5)
    g = reg.gauge("depth", "Depth.")
    g.set(4)
    g.inc()
    g.dec(2)
    g.set_max(10)
    g.set_max(5)
    h = reg.histogram("lat_seconds", "Latency.", buckets=(0.1, 1.0))
    for v in (0.05, 0.1, 0.5, 7.0):
        h.observe(v)


def _labelled(reg):
    c = reg.counter("hits_total", "Hits \"quoted\" and \\slashed.",
                    labelnames=("verb", "code"))
    c.labels(verb="GET", code=200).inc()
    c.labels("GET", "200").inc()
    c.labels(verb='P"U\\T', code=500).inc(3)
    g = reg.gauge("util", "Used.", labelnames=("shard", "kv_dtype"))
    g.labels(shard="0", kv_dtype="int8").set(0.25)
    g.labels(shard="1", kv_dtype="int8").set(float("inf"))
    h = reg.histogram("tpot_seconds", "Per token.",
                      labelnames=("priority",),
                      buckets=tobs.LATENCY_BUCKETS)
    for i, v in enumerate((1e-5, 3e-4, 0.02, 0.7, 40.0)):
        h.labels(priority=("interactive", "batch")[i % 2]).observe(v)


def _reset(reg):
    c = reg.counter("a_total", labelnames=("k",))
    handle = c.labels(k="x")
    handle.inc(5)
    reg.histogram("h_seconds", buckets=(1.0, float("inf"))).observe(0.5)
    reg.reset()
    handle.inc()
    reg.gauge("nan_gauge", "Not a number.").set(float("nan"))


def _errors(reg):
    c = reg.counter("hits_total", "Hits.", labelnames=("verb", "code"))
    out = [_raised(lambda: c.labels(verb="GET", code=1).inc(-1)),
           _raised(lambda: c.labels(verb="GET")),
           _raised(lambda: c.labels("GET")),
           _raised(lambda: c.inc()),
           _raised(lambda: reg.gauge("hits_total")),
           _raised(lambda: reg.counter("hits_total", labelnames=("v",))),
           _raised(lambda: reg.histogram("h2", labelnames=("le",))),
           _raised(lambda: reg.counter("bad-name")),
           _raised(lambda: reg.histogram("h3", buckets=(2.0, 1.0))),
           _raised(lambda: reg.counter("up_total").inc(-1))]
    assert reg.counter("hits_total", labelnames=("verb", "code")) is c
    return out


SCRIPTS = {"basics": _basics, "labelled": _labelled, "reset": _reset,
           "errors": _errors}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_registry_snapshot_and_exposition_are_jax_s(name):
    """The same operations on both registries: equal snapshots (as JSON),
    equal errors, byte-identical Prometheus text that parses back the
    same, and the JSON-safe form (`json_sanitize`) equal."""
    regs = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    outs = [SCRIPTS[name](r) for r in regs]
    assert outs[0] == outs[1]
    snaps = [r.snapshot() for r in regs]
    assert json.dumps(snaps[0], sort_keys=True) == \
        json.dumps(snaps[1], sort_keys=True)
    texts = [r.render_prometheus() for r in regs]
    assert texts[0] == texts[1]
    assert texts[1] == tobs.render_prometheus(snaps[1])
    assert repr(jobs.parse_prometheus(texts[0])) == \
        repr(tobs.parse_prometheus(texts[1]))
    from paddle_tpu.observability.metrics import json_sanitize as jsan
    from paddle_tpu_torch.observability.metrics import json_sanitize as tsan
    assert jsan(snaps[0]) == tsan(snaps[1])


def test_merge_snapshots_quantiles_and_labels_are_jax_s():
    """Three ranks' snapshots fold alike in both packages (counters and
    buckets summed, gauges min/max/mean, a series one rank has); refused
    bucket bounds raise alike; quantiles, `series_total` and
    `label_snapshot` agree."""
    def ranks(pkg):
        snaps = []
        for i in range(3):
            reg = pkg.MetricsRegistry()
            c = reg.counter("n_total", "count", labelnames=("kind",))
            c.labels(kind="a").inc(i + 1)
            if i == 2:
                c.labels(kind="b").inc(10)
            reg.gauge("g", "gauge").set(float(i))
            h = reg.histogram("h_seconds", "hist", buckets=(0.1, 1.0))
            for _ in range(i + 1):
                h.observe(0.05)
            h.observe(5.0)
            snaps.append(reg.snapshot())
        return snaps

    got = [pkg.merge_snapshots(ranks(pkg)) for pkg in (jobs, tobs)]
    assert json.dumps(got[0], sort_keys=True) == \
        json.dumps(got[1], sort_keys=True)
    assert tobs.series_total(got[1], "n_total") == \
        jobs.series_total(got[0], "n_total") == 16
    labelled = [pkg.label_snapshot(s, replica="r1")
                for pkg, s in zip((jobs, tobs), got)]
    assert labelled[0] == labelled[1]
    for counts, q in (([0, 0], 0.5), ([2, 2], 0.25), ([2, 2], 0.75),
                      ([0, 1], 1.0)):
        assert tobs.quantile_from_buckets((1.0, 2.0), counts, q) == \
            jobs.quantile_from_buckets((1.0, 2.0), counts, q)

    def bad(pkg):
        reg = pkg.MetricsRegistry()
        reg.histogram("h_seconds", "hist", buckets=(0.2, 2.0)).observe(0.1)
        return _raised(lambda: pkg.merge_snapshots(
            [ranks(pkg)[0], reg.snapshot()]))
    assert bad(tobs) == bad(jobs) is not None


def test_metrics_server_serves_the_exposition_on_loopback():
    reg = tobs.MetricsRegistry()
    reg.counter("scraped_total", "Scrapes.").inc(4)
    with tobs.MetricsServer(reg) as srv:
        assert srv.url.startswith("http://127.0.0.1:")
        with urllib.request.urlopen(srv.url, timeout=10) as resp:
            assert resp.read().decode() == reg.render_prometheus()
        with urllib.request.urlopen(srv.url + ".json", timeout=10) as resp:
            assert json.load(resp) == reg.snapshot()
    assert _raised(lambda: tobs.MetricsServer(reg, host="0.0.0.0")) == \
        _raised(lambda: jobs.MetricsServer(reg, host="0.0.0.0"))


def test_aggregate_one_member_and_refusal():
    """One member: the local snapshot through the merge, as JAX's
    `aggregate` returns it; more members need the collective tier, not
    ported (ROADMAP Queue A 13)."""
    regs = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    for r in regs:
        r.counter("solo_total").inc(3)
    assert tobs.aggregate(registry=regs[1]) == \
        jobs.aggregate(registry=regs[0]) == \
        tobs.merge_snapshots([regs[1].snapshot()])

    class Group:
        ranks = (0, 1)

    with pytest.raises(NotImplementedError, match="Queue A 13"):
        tobs.aggregate(group=Group(), registry=regs[1])


def test_all_is_jax_s():
    assert sorted(tobs.__all__) == sorted(jobs.__all__)


def test_import_initializes_no_cuda_context():
    """The tier's modules import no torch at module level (memory
    sampling and the fold import it lazily), and importing the package
    leaves CUDA uninitialized."""
    pkg = os.path.join(REPO, "paddle_tpu_torch", "observability")
    for fname in sorted(os.listdir(pkg)):
        if not fname.endswith(".py"):
            continue
        with open(os.path.join(pkg, fname)) as f:
            tree = ast.parse(f.read())
        top = [n for n in tree.body
               if isinstance(n, (ast.Import, ast.ImportFrom))]
        names = [a.name for n in top if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module or "" for n in top
                  if isinstance(n, ast.ImportFrom)]
        assert not any(m.split(".")[0] in ("torch", "numpy", "jax")
                       for m in names), (fname, names)
    code = ("import paddle_tpu_torch.observability as obs, torch\n"
            "r = obs.MetricsRegistry(); r.counter('a_total').inc()\n"
            "assert 'a_total 1' in r.render_prometheus()\n"
            "assert not torch.cuda.is_initialized()\n"
            "print('SMOKE_OK')\n")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "SMOKE_OK" in res.stdout, \
        res.stdout + res.stderr


# -- training telemetry --------------------------------------------------------

def _mlp_pair(seed):
    """One MLP in both packages, the same weights, SGD(0.1) each."""
    paddle.seed(seed)
    jnet = jnn.Sequential(jnn.Linear(8, 16), jnn.Tanh(), jnn.Linear(16, 4))
    tnet = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                               torch.nn.Linear(16, 4))
    with torch.no_grad():
        for jl, tl in zip((jnet[0], jnet[2]), (tnet[0], tnet[2])):
            tl.weight.copy_(torch.from_numpy(np.array(jl.weight._array).T))
            tl.bias.copy_(torch.from_numpy(np.array(jl.bias._array)))
    return (jnet, JSGD(0.1, parameters=jnet.parameters()), tnet,
            SGD(0.1, parameters=tnet.parameters()))


def _t(a):
    return paddle.to_tensor(a)


@pytest.mark.parametrize("K", [1, 3])
def test_trainstep_telemetry_observes_as_jax(K):
    """Five calls at `accumulate_steps=K`, a failed call in the middle:
    the observation counts (steps, step-time samples, tokens) are JAX's
    (one a step, one a window, none for the window the failure broke),
    and the loss gauge is within 1e-6 of JAX's."""
    jnet, jopt, tnet, topt = _mlp_pair(3)
    regs = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    jtel = jobs.TrainingTelemetry(registry=regs[0], tokens_per_step=32)
    ttel = tobs.TrainingTelemetry(registry=regs[1], tokens_per_step=32)
    jstep = jjit.TrainStep(jnet, jopt, JF.mse_loss, accumulate_steps=K,
                           telemetry=jtel)
    tstep = TrainStep(tnet, topt, mse_loss, accumulate_steps=K,
                      telemetry=ttel)
    rs = np.random.RandomState(4)
    data = [(rs.randn(4, 8).astype(np.float32),
             rs.randn(4, 4).astype(np.float32)) for _ in range(3 * K)]
    bad = np.zeros((4, 5), np.float32)             # the wrong width
    for i, (x, y) in enumerate(data):
        if i == K + 1:
            for step, wrap in ((jstep, _t), (tstep, torch.from_numpy)):
                with pytest.raises(Exception):
                    step(wrap(bad), wrap(y))
        jstep(_t(x), _t(y))
        tstep(torch.from_numpy(x), torch.from_numpy(y))
    snaps = [r.snapshot() for r in regs]
    for name in ("train_steps_total", "train_tokens_total"):
        assert snaps[1][name]["series"] == snaps[0][name]["series"], name
    counts = [s["train_step_seconds"]["series"][0]["count"] for s in snaps]
    assert counts[0] == counts[1] == (3 if K == 1 else 2)
    losses = [s["train_loss"]["series"][0]["value"] for s in snaps]
    assert abs(losses[0] - losses[1]) <= 1e-6


def test_trainstep_telemetry_leaves_the_update_bitwise():
    """A telemetry step trains exactly as a plain one: the same losses and
    parameters, bit for bit, over a merge window."""
    _, _, a, opt_a = _mlp_pair(5)
    _, _, b, opt_b = _mlp_pair(5)
    tel = tobs.TrainingTelemetry(registry=tobs.MetricsRegistry())
    sa = TrainStep(a, opt_a, mse_loss, accumulate_steps=2, telemetry=tel)
    sb = TrainStep(b, opt_b, mse_loss, accumulate_steps=2)
    rs = np.random.RandomState(6)
    for _ in range(4):
        x = torch.from_numpy(rs.randn(4, 8).astype(np.float32))
        y = torch.from_numpy(rs.randn(4, 4).astype(np.float32))
        assert torch.equal(sa(x, y), sb(x, y))
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)


def test_telemetry_observe_step_and_memory_refusal_on_the_cpu():
    """`observe_step` fills JAX's gauges; memory statistics need a card
    (the CPU's live-array accounting is ROADMAP Queue A 13)."""
    regs = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    for pkg, reg in zip((jobs, tobs), regs):
        pkg.TrainingTelemetry(registry=reg, tokens_per_step=64) \
            .observe_step(0.5, grad_norm=1.25, loss=0.75)
    assert json.dumps(regs[0].snapshot(), sort_keys=True) == \
        json.dumps(regs[1].snapshot(), sort_keys=True)
    tel = tobs.TrainingTelemetry(registry=regs[1], memory_every=1)
    with pytest.raises(NotImplementedError, match="Queue A 13"):
        tel.record_memory("cpu")
    with pytest.raises(NotImplementedError, match="Queue A 13"):
        tel.observe_step(0.1)                   # memory_every=1 samples


# -- the profiler's host half ---------------------------------------------------

def test_profiler_scheduler_is_jax_s_and_device_trace_refused():
    kw = dict(closed=1, ready=1, record=2, repeat=2, skip_first=1)
    jsched, tsched = jprof.make_scheduler(**kw), tprof.make_scheduler(**kw)
    assert [tsched(i).name for i in range(12)] == \
        [jsched(i).name for i in range(12)]
    for make in (lambda: tprof.Profiler(),
                 lambda: tprof.Profiler(timer_only=True).summary()):
        with pytest.raises(NotImplementedError, match="Queue A 13"):
            make()


def test_profiler_records_the_engine_spans(tmp_path):
    """`Profiler(timer_only=True)` records the engine's `engine.step`,
    `engine.prefill`, `engine.decode` and `engine.cow` spans and exports
    them through `export_chrome_tracing`."""
    torch.manual_seed(0)
    model = GPTForCausalLM(GPTConfig.tiny(vocab=32, hidden=16, layers=1,
                                          heads=2, seq=32),
                           device="cpu").eval()
    eng = GenerationEngine(model, device="cpu", num_slots=2, block_size=4,
                           prefill_chunk=4)
    prompt = np.arange(8, dtype=np.int32)
    with tprof.Profiler(timer_only=True, on_trace_ready=tprof
                        .export_chrome_tracing(str(tmp_path))) as prof:
        eng.add_request(prompt, 3)
        eng.run()
        eng.add_request(prompt, 3)                 # full hit: a COW
        eng.run()
    with open(prof._export_path) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert {"engine.step", "engine.prefill", "engine.decode",
            "engine.cow"} <= names
