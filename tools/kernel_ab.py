"""Time the hand-written kernels of the later redesigns of one checkout on
the card, at the shapes of chip_smoke.py's phases int8_linear, sdpa_bwd,
lora and sampling.

Run it on two checkouts in turns within one machine (parent, change,
change, parent) to compare two designs on one card:

    python tools/kernel_ab.py --tree DIR --label NAME

`DIR` is the root of a checkout (the repository itself by default); its
`paddle_tpu_torch` is imported and its kernels are built into its own
`build/`. The timing helpers are this checkout's `chip_smoke.py`'s. Prints
one JSON object: the card's name and power limit, then
- for each int8 case (qkv, out, fc1, fc2 at M 8, 40, 128) the kernel's
  time over weight copies past the L2 cache and `torch.matmul` over the
  dequantized bf16 weight timed the same way, the decode step's sums over
  24 layers at M 8;
- for each bf16 backward case of `SDPA_BWD_SHAPES` with D <= 256 one
  call's time after an L2 flush, each of its kernels' device time from
  torch.profiler, and the host's time for one call (the wrapper's work
  and its launches, with nothing queued before it);
- for each LoRA site of GPT-1.3B (qkv, out, fc1, fc2) at rank 16 and 8 x 1,
  8 x 5 and 1 x 128 rows, the kernel's time by CUDA-graph replays with the
  L2 warm and over copies of the pool past it, the gathered factors
  through two `torch.bmm` timed the same way, the host's time of one
  `LoraState.add` and of one direct `batched_lora` call, and the decode
  step's sums over its 96 sites;
- the categorical draw at N 8 and 40 over V 50,304: its time by graph
  replays over copies of the logits past the L2, with and without the
  verify step's exclusions, one call's time by graph replays after an L2
  flush (a graph launch's latency in it), and the host's time of one
  call; and the verify step's two draws (the draw with exclusions and
  the acceptance coin) timed the same way, as the checkout computes
  them: two launches where it has `sample_uniform` (and the coin's
  launch alone, by graph replays), the one fused launch where it has
  `verify_draws`.
Needs a CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    """This checkout's chip_smoke.py, as a module of helpers."""
    spec = importlib.util.spec_from_file_location(
        "_kernel_ab_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_int8(torch, cs):
    from paddle_tpu_torch.ops.int8_linear import int8_linear
    from paddle_tpu_torch.quantization import dequantize, quantize_absmax

    g = torch.Generator("cuda").manual_seed(3)
    cases, step = [], {"int8_ms": 0.0, "bf16_matmul_ms": 0.0}
    for name, K, N in cs.W8_SHAPES:
        w = (torch.randn((N, K), generator=g, device="cuda") * 0.02).to(
            torch.bfloat16)
        q, s = quantize_absmax(w, axis=0)
        b = (torch.randn(N, generator=g, device="cuda") * 0.1).to(
            torch.bfloat16)
        cq = [(q.clone(), s.clone(), b.clone())
              for _ in range(cs._copies(N * K))]
        wdq = dequantize(q, s, torch.bfloat16)
        cw = [wdq.clone() for _ in range(cs._copies(2 * N * K))]
        for M in cs.W8_ROWS:
            x = torch.randn((M, K), generator=g, device="cuda").to(
                torch.bfloat16)
            ms = cs._graph_ms_cold(torch, [
                (lambda c=c: int8_linear(x, *c)) for c in cq])
            lms = cs._graph_ms_cold(torch, [
                (lambda c=c: torch.matmul(x, c.t())) for c in cw])
            bnd, _ = cs.bound_ms(N * K + 2 * M * K + 2 * M * N + 4 * N,
                                 2 * M * N * K, "bfloat16")
            cases.append({"shape": name, "M": M, "N": N, "K": K, "ms": ms,
                          "bf16_matmul_ms": lms, "bound_ms": bnd,
                          "share_of_bound": bnd / ms})
            if M == cs.W8_ROWS[0]:
                step["int8_ms"] += 24 * ms
                step["bf16_matmul_ms"] += 24 * lms
        del cq, cw
    return {"cases": cases, "decode_step_24_layers_m8": step}


def _profile_sdpa_bwd(torch, call, iters=10):
    """Each kernel's mean device time in us over `iters` calls, from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    return {e.key.replace("(anonymous namespace)::", "").replace(
        "void ", "").split("(")[0]: e.device_time_total / e.count
            for e in prof.key_averages() if e.device_time_total > 0}


def _host_us(torch, call, iters=50):
    """Median wall time in us until one call returns, the device idle
    before each: the host's share of a call that the device does not
    hide."""
    call()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return sorted(times)[iters // 2] * 1e6


def time_sdpa_bwd(torch, cs):
    from paddle_tpu_torch.ops.flash_attention import (sdpa_backward,
                                                      sdpa_forward)

    g = torch.Generator("cuda").manual_seed(14)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    cases = []
    for name, B, H, Sq, Skv, D, causal in cs.SDPA_BWD_SHAPES:
        if D > 256:
            continue
        BH, scale = B * H, 1.0 / math.sqrt(D)
        q, do = (torch.randn((BH, Sq, D), generator=g, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((BH, Skv, D), generator=g, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        o, lse = sdpa_forward(q, k, v, scale, causal, return_lse=True)
        call = lambda: sdpa_backward(q, k, v, o, do, lse, scale, causal)
        ms = cs._graph_call_ms(torch, call, flush)
        bnd, by, flops = cs._sdpa_bwd_bound(BH, Sq, Skv, D, causal, 2,
                                            "bfloat16")
        cases.append({"shape": name, "B": B, "H": H, "Sq": Sq, "Skv": Skv,
                      "D": D, "causal": causal, "ms": ms, "bound_ms": bnd,
                      "tflops": flops / ms / 1e9,
                      "kernel_us": _profile_sdpa_bwd(torch, call),
                      "host_us": _host_us(torch, call)})
        del q, k, v, do, o, lse
    return {"cases": cases}


def time_lora(torch, cs):
    from paddle_tpu_torch.ops.lora import LoraState, batched_lora

    g = torch.Generator("cuda").manual_seed(5)
    R, layer = 16, 1
    pools = {site[0]: cs._lora_pool(torch, g, site, R, torch.bfloat16)
             for site in cs.LORA_SITES_1P3B}
    sc = pools["qkv"][2]
    arrays = [t for name in ("qkv", "out", "fc1", "fc2")
              for t in pools[name][:2]] + [sc]
    cases, step = [], {"ms": 0.0, "cold_l2_ms": 0.0, "bmm_ms": 0.0,
                       "host_us_state": 0.0}
    for B, S in cs.LORA_ROWS:
        rows = (torch.arange(1, B + 1, dtype=torch.int32, device="cuda")
                if B == 8 else torch.tensor([4], dtype=torch.int32,
                                            device="cuda"))
        state = LoraState(arrays, rows)
        for site in cs.LORA_SITES_1P3B:
            name, n_in, n_out, _ = site
            a16, b16, _ = pools[name]
            x = torch.randn((B, S, n_in), generator=g,
                            device="cuda").to(torch.bfloat16)
            base = torch.randn((B, S, n_out), generator=g,
                               device="cuda").to(torch.bfloat16)
            call = lambda: batched_lora(base, x, a16, b16, rows, sc, layer)
            ms = cs._graph_ms(torch, call)
            pool = [(a16.clone(), b16.clone()) for _ in range(
                cs._copies(2 * (a16.numel() + b16.numel())))]
            cold = cs._graph_ms_cold(torch, [
                (lambda c=c: batched_lora(base, x, c[0], c[1], rows, sc,
                                          layer)) for c in pool])
            del pool

            def bmm_route():
                r = rows.long()
                al = a16[r, layer]
                bl = b16[r, layer].reshape(B, R, n_out)
                xr = torch.bmm(x, al.transpose(1, 2))
                return base + torch.bmm(xr, bl) * \
                    sc[r].to(torch.bfloat16)[:, None, None]

            bmm = cs._graph_ms(torch, bmm_route)
            host_state = _host_us(torch, lambda: state.add(name, base, x,
                                                           layer))
            host_call = _host_us(torch, call)
            bnd, _ = cs._lora_bound(B, S, R, n_in, n_out,
                                    int(rows.unique().numel()), 2,
                                    "bfloat16")
            cases.append({"site": name, "slots": B, "rows_a_slot": S,
                          "ms": ms, "cold_l2_ms": cold, "bmm_ms": bmm,
                          "bound_ms": bnd, "host_us_state": host_state,
                          "host_us_call": host_call})
            if (B, S) == cs.LORA_ROWS[0]:
                step["ms"] += 24 * ms
                step["cold_l2_ms"] += 24 * cold
                step["bmm_ms"] += 24 * bmm
                step["host_us_state"] += 24 * host_state
    return {"cases": cases, "decode_step_96_sites": step}


def time_draw(torch, cs):
    """The draws at the decode step's and the verify step's rows: the
    coin-free draw alone (with and without the verify step's exclusions),
    and the verify step's two draws, a checkout's way: the draw with
    exclusions and then the separate coin launch (`sample_uniform`) where
    the checkout has it, the one fused launch (`verify_draws`) where it has
    that."""
    from paddle_tpu_torch.inference.sampling import key_row
    from paddle_tpu_torch.ops import sampling as sops

    V = 50304
    g = torch.Generator("cuda").manual_seed(2)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    cases = []
    for N in cs.SAMPLING_ROWS:
        raw = torch.randn((N, V), generator=g, device="cuda") * 3
        lg = sops.masked_logits(raw, torch.full((N,), 0.8, device="cuda"),
                                torch.full((N,), 50, dtype=torch.int32,
                                           device="cuda"),
                                torch.full((N,), 0.9, device="cuda"))
        keys = torch.stack([key_row(cs.SEED + i) for i in range(N)]).cuda()
        pos = torch.randint(0, 2048, (N,), generator=g, device="cuda",
                            dtype=torch.int32)
        ex = torch.where(torch.arange(N, device="cuda") % 2 == 0,
                         lg.argmax(-1), -1).to(torch.int32)
        copies = [lg.clone() for _ in range(cs._copies(lg.numel() * 4))]
        ms = cs._graph_ms_cold(torch, [
            (lambda c=c: sops.sample_draw(c, keys, pos, 0)) for c in copies])
        xms = cs._graph_ms_cold(torch, [
            (lambda c=c: sops.sample_draw(c, keys, pos, 0, ex))
            for c in copies])
        case = {"N": N, "V": V, "ms": ms, "excluded_ms": xms}
        if hasattr(sops, "verify_draws"):
            pair = "fused"
            step = lambda c: sops.verify_draws(c, keys, pos, ex)
        else:
            pair = "draw_then_coin"
            step = lambda c: (sops.sample_draw(c, keys, pos, 0, ex),
                              sops.sample_uniform(keys, pos, 1))
            # the coin's own launch alone (it reads no logits)
            case["coin_ms"] = cs._graph_ms(
                torch, lambda: sops.sample_uniform(keys, pos, 1))
        case["verify_pair"] = pair
        case["verify_pair_ms"] = cs._graph_ms_cold(torch, [
            (lambda c=c: step(c)) for c in copies])
        del copies
        call = lambda: sops.sample_draw(lg, keys, pos, 0)
        case.update(one_call_flushed_ms=cs._graph_call_ms(torch, call,
                                                          flush),
                    host_us=_host_us(torch, call),
                    verify_pair_host_us=_host_us(torch, lambda: step(lg)))
        cases.append(case)
    return {"cases": cases}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT,
                    help="root of the checkout to time (default: this one)")
    ap.add_argument("--label", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 2
    cs = _smoke()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from paddle_tpu_torch.utils import cpp_extension

    if not cpp_extension.__file__.startswith(tree):
        print(f"kernel_ab: imported {cpp_extension.__file__}, not the "
              f"checkout at {tree}", file=sys.stderr)
        return 2
    cpp_extension.build(["int8_linear", "sdpa_backward", "sdpa_forward",
                         "lora", "sampling"])
    out = {"tree": args.label or tree, "nvidia_smi": cs.nvidia_smi_line()}
    out["int8_linear"] = time_int8(torch, cs)
    out["sdpa_backward"] = time_sdpa_bwd(torch, cs)
    out["lora"] = time_lora(torch, cs)
    out["sample_draw"] = time_draw(torch, cs)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
