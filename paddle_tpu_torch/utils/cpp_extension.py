"""Build and load the port's CUDA kernels: counterpart of
paddle_tpu/utils/cpp_extension.py.

Each kernel is a `.cu` file under `paddle_tpu_torch/csrc/` with a plain C
interface, and may include a shared `.cuh` header from there. `nvcc`
compiles it for `sm_90a` into a shared library under
`build/paddle_tpu_torch/` at the root of the checkout, named by a hash of
its sources and flags, and `ctypes` loads it. No PyTorch header is
included, so a build takes seconds, not minutes. Every pointer and the
stream cross as `c_void_p`.

A kernel builds at its first use, so a fresh checkout builds everything the
first time it runs; `build` compiles several kernels at once, one `nvcc`
process per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["KERNEL_SOURCES", "NVCC_FLAGS", "BUILD_DIR", "build", "load",
           "find_nvcc"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "paddle_tpu_torch")

#: kernel library name -> its sources under csrc/: the `.cu` files nvcc
#: compiles and the `.cuh` headers they include (hashed with them)
KERNEL_SOURCES = {
    "paged_decode": ("paged_decode.cu", "paged_split.cuh",
                     "attention_mma.cuh"),
    "paged_verify": ("paged_verify.cu", "paged_split.cuh",
                     "attention_mma.cuh"),
    "causal_attention": ("causal_attention.cu", "attention_mma.cuh"),
    "causal_attention_bwd": ("causal_attention_bwd.cu", "attention_bwd.cuh",
                             "attention_mma.cuh"),
    "shortseq_attention": ("shortseq_attention.cu", "attention_mma.cuh"),
    "shortseq_attention_bwd": ("shortseq_attention_bwd.cu",
                               "attention_bwd.cuh", "attention_mma.cuh"),
    "sdpa_forward": ("sdpa_forward.cu", "attention_mma.cuh"),
    "sdpa_backward": ("sdpa_backward.cu", "attention_bwd.cuh",
                      "attention_mma.cuh"),
    "optimizer_update": ("optimizer_update.cu", "table_walk.cuh"),
    "grad_merge": ("grad_merge.cu", "table_walk.cuh"),
    "conv_bn_relu": ("conv_bn_relu.cu", "conv_common.cuh", "conv_mma.cuh",
                     "attention_mma.cuh"),
    "conv_bn_relu_bwd": ("conv_bn_relu_bwd.cu", "conv_common.cuh",
                         "conv_mma.cuh", "attention_mma.cuh"),
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# a library is loaded once per process (ctypes cannot unload it)
_LOADED = {}
_LOCK = threading.Lock()


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, then PATH, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels build only where the toolkit is")


def _library_path(name):
    h = hashlib.sha256(repr(NVCC_FLAGS).encode())
    for src in KERNEL_SOURCES[name]:
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(names=None) -> dict:
    """Compile the named kernel libraries (all by default) that are not
    built yet, one nvcc per library, all running at once. Returns
    {name: {"path", "seconds", "cached", "log"}}; `log` holds nvcc's
    output (ptxas register and spill counts). Raises if any build fails,
    with that build's output."""
    names = list(KERNEL_SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    info, procs = {}, {}
    nvcc = None
    for name in names:
        path = _library_path(name)
        if os.path.exists(path):
            info[name] = {"path": path, "seconds": 0.0, "cached": True,
                          "log": ""}
            continue
        nvcc = nvcc or find_nvcc()
        tmp = f"{path}.{os.getpid()}.tmp"
        srcs = [os.path.join(CSRC, s) for s in KERNEL_SOURCES[name]
                if s.endswith(".cu")]
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *srcs]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       path, tmp, time.perf_counter())
    failed = []
    for name, (proc, path, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
        info[name] = {"path": path, "seconds": secs, "cached": False,
                      "log": log}
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return info


def load(name) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name]["path"])
            _LOADED[name] = lib
        return lib
