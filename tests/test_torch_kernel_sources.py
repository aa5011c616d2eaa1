"""The port's kernel sources as the build sees them, read without a
compiler: every kernel that `chip_smoke.py` requires to run on the tensor
cores (`MMA_KERNELS`) is a `__global__` function of the `.cu` files that
`KERNEL_SOURCES` lists for its library, and every header a library's
`.cu` file includes from `csrc/` is listed for that library, so that a
change to the header changes the library's hash and rebuilds it."""
import importlib.util
import re
from pathlib import Path

import pytest

from paddle_tpu_torch.utils.cpp_extension import CSRC, KERNEL_SOURCES

REPO = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MMA_KERNELS = _chip_smoke().MMA_KERNELS


def _cu_sources(lib):
    return [Path(CSRC) / s for s in KERNEL_SOURCES[lib] if s.endswith(".cu")]


def _globals(lib):
    """Names of the `__global__` functions defined in a library's `.cu`
    files."""
    names = set()
    for path in _cu_sources(lib):
        text = re.sub(r"__launch_bounds__\([^)]*\)", "", path.read_text())
        names.update(re.findall(r"__global__\s+void\s+(\w+)\s*\(", text))
    return names


@pytest.mark.parametrize("lib", sorted(MMA_KERNELS))
def test_mma_kernels_are_kernels_of_their_library(lib):
    assert lib in KERNEL_SOURCES
    missing = set(MMA_KERNELS[lib]) - _globals(lib)
    assert not missing, f"{lib}: no __global__ {sorted(missing)}"


@pytest.mark.parametrize("lib", sorted(KERNEL_SOURCES))
def test_included_headers_are_listed_with_their_library(lib):
    srcs = _cu_sources(lib)
    assert srcs and all(p.is_file() for p in srcs)
    included = {h for p in srcs
                for h in re.findall(r'#include\s+"([^"]+)"', p.read_text())}
    assert included <= set(KERNEL_SOURCES[lib]), (
        f"{lib} includes {sorted(included - set(KERNEL_SOURCES[lib]))} "
        f"without listing it")
    assert all((Path(CSRC) / h).is_file() for h in included)


def test_attention_mma_header_is_listed_wherever_it_is_included():
    users = {lib for lib in KERNEL_SOURCES for p in _cu_sources(lib)
             if '#include "attention_mma.cuh"' in p.read_text()}
    listed = {lib for lib, srcs in KERNEL_SOURCES.items()
              if "attention_mma.cuh" in srcs}
    assert users == listed
    assert set(MMA_KERNELS) <= users
