"""Time the bf16 int8-weight linear and the library route's attention
backward of one checkout on the card, by CUDA-graph replays, at the shapes
of chip_smoke.py's phases int8_linear and sdpa_bwd.

Run it on two checkouts in turns within one machine (parent, change,
change, parent) to compare two designs on one card:

    python tools/kernel_ab.py --tree DIR --label NAME

`DIR` is the root of a checkout (the repository itself by default); its
`paddle_tpu_torch` is imported and its kernels are built into its own
`build/`. The timing helpers are this checkout's `chip_smoke.py`'s. Prints
one JSON object: the card's name and power limit, then for each int8 case
(qkv, out, fc1, fc2 at M 8, 40, 128) the kernel's time over weight copies
past the L2 cache and `torch.matmul` over the dequantized bf16 weight
timed the same way, the decode step's sums over 24 layers at M 8, and for
each bf16 backward case of `SDPA_BWD_SHAPES` with D <= 256 one call's
time after an L2 flush, each of its kernels' device time from
torch.profiler, and the host's time for one call (the wrapper's work and
its launches, with nothing queued before it). Needs a CUDA device; imports nothing of
JAX.
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
    cpp_extension.build(["int8_linear", "sdpa_backward", "sdpa_forward"])
    out = {"tree": args.label or tree, "nvidia_smi": cs.nvidia_smi_line()}
    out["int8_linear"] = time_int8(torch, cs)
    out["sdpa_backward"] = time_sdpa_bwd(torch, cs)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
