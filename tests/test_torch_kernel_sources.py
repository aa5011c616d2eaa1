"""The port's kernel sources as the build sees them, read without a
compiler: every kernel that `chip_smoke.py` requires to run on the tensor
cores (`MMA_KERNELS`) is a `__global__` function of the `.cu` files that
`KERNEL_SOURCES` lists for its library, and every header a library's
`.cu` file includes from `csrc/`, directly or through another header, is
listed for that library, so that a change to the header changes the
library's hash and rebuilds it. The causal (B2) and shortseq (B13)
backwards share one source, `attention_bwd.cuh`: each `.cu` keeps only
thin kernels over its bodies, and `chip_smoke.py`'s profile families
still tell the two apart by their kernels' names. The library route's
backward (`sdpa_backward.cu`) runs the header's tensor-core bodies too,
beside a design of its own, and its profile family is its own."""
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


CHIP_SMOKE = _chip_smoke()
MMA_KERNELS = CHIP_SMOKE.MMA_KERNELS
BWD_LIBS = ("causal_attention_bwd", "shortseq_attention_bwd")
# every library that includes attention_bwd.cuh
HEADER_LIBS = BWD_LIBS + ("sdpa_backward",)
# the `__device__` bodies of the attention backward, in attention_bwd.cuh
BWD_BODIES = ("delta_fma", "dkdv_fma", "dq_fma", "delta_mma", "dkdv_mma",
              "dq_mma")


def _cu_sources(lib):
    return [Path(CSRC) / s for s in KERNEL_SOURCES[lib] if s.endswith(".cu")]


def _includes(path):
    return re.findall(r'#include\s+"([^"]+)"', path.read_text())


def _included(lib):
    """The headers from csrc/ a library's `.cu` files include, directly or
    through another header."""
    seen, todo = set(), [h for p in _cu_sources(lib) for h in _includes(p)]
    while todo:
        h = todo.pop()
        if h not in seen:
            seen.add(h)
            todo += _includes(Path(CSRC) / h)
    return seen


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
    included = _included(lib)
    assert included <= set(KERNEL_SOURCES[lib]), (
        f"{lib} includes {sorted(included - set(KERNEL_SOURCES[lib]))} "
        f"without listing it")
    assert all((Path(CSRC) / h).is_file() for h in included)
    listed = {h for h in KERNEL_SOURCES[lib] if h.endswith(".cuh")}
    assert listed <= included, f"{lib} lists {sorted(listed - included)}"


def test_attention_mma_header_is_listed_wherever_it_is_included():
    users = {lib for lib in KERNEL_SOURCES
             if "attention_mma.cuh" in _included(lib)}
    listed = {lib for lib, srcs in KERNEL_SOURCES.items()
              if "attention_mma.cuh" in srcs}
    assert users == listed
    assert set(MMA_KERNELS) <= users


def test_attention_bwd_header_serves_both_backward_libraries():
    users = {lib for lib in KERNEL_SOURCES
             if "attention_bwd.cuh" in _included(lib)}
    listed = {lib for lib, srcs in KERNEL_SOURCES.items()
              if "attention_bwd.cuh" in srcs}
    assert users == listed == set(HEADER_LIBS)


@pytest.mark.parametrize("lib", BWD_LIBS)
def test_backward_bodies_live_in_the_shared_header_alone(lib):
    """Each backward library's `.cu` calls every body of the header and
    keeps no device arithmetic of its own: no shared memory, no product,
    no copy of a body."""
    header = (Path(CSRC) / "attention_bwd.cuh").read_text()
    for body in BWD_BODIES:
        assert re.search(rf"__device__ __forceinline__ void {body}\(",
                         header), body
    for path in _cu_sources(lib):
        text = path.read_text()
        assert '#include "attention_bwd.cuh"' in text
        for body in BWD_BODIES:
            assert f"attn_bwd::{body}<" in text, (path.name, body)
        for mark in ("__shared__", "mma_bf16(", "ldsm_x4", "cp_async",
                     "__device__", "exp2f(", "expf("):
            assert mark not in text, (path.name, mark)


# every kernel of the two attention backwards and of the conv backward, as
# torch.profiler names it, against the family chip_smoke.py files it under
FAMILY_OF_LIB = {"causal_attention_bwd": "causal_bwd_kernels",
                 "shortseq_attention_bwd": "shortseq_bwd_kernels",
                 "sdpa_backward": "sdpa_bwd_kernels",
                 "optimizer_update": "optimizer_update_kernel",
                 "grad_merge": "grad_merge_kernels"}


def _profiled_name(kernel):
    return (f"void (anonymous namespace)::{kernel}<64, false>"
            f"(__nv_bfloat16 const*, float const*, int, float)")


@pytest.mark.parametrize("lib,kernel", sorted(
    (lib, k) for lib in FAMILY_OF_LIB for k in _globals(lib)))
def test_profile_family_of_attention_backward_kernels(lib, kernel):
    assert CHIP_SMOKE.kernel_family(_profiled_name(kernel)) == \
        FAMILY_OF_LIB[lib]


@pytest.mark.parametrize("kernel,family", [
    ("conv3x3_dw_mma_kernel", "conv3x3_dw_kernel"),
    ("conv3x3_dw_kernel", "conv3x3_dw_kernel"),
    ("conv1x1_bwd_dx_kernel", "conv1x1_bwd_kernels"),
    ("conv1x1_bwd_dw_kernel", "conv1x1_bwd_kernels"),
    ("conv1x1_bwd_dx_mma_kernel", "conv1x1_bwd_kernels"),
    ("conv1x1_bwd_dw_mma_kernel", "conv1x1_bwd_kernels"),
    ("conv3x3_bn_relu_mma_kernel", "conv3x3_bn_relu_kernel"),
    ("conv3x3_bn_relu_kernel", "conv3x3_bn_relu_kernel"),
    ("conv1x1_bn_relu_kernel", "conv1x1_bn_relu_kernel"),
    ("conv1x1_bn_relu_mma_kernel", "conv1x1_bn_relu_kernel"),
    ("conv1x1_train_kernel", "conv1x1_train_kernel"),
    ("conv1x1_train_mma_kernel", "conv1x1_train_kernel"),
    ("conv3x3_train_kernel", "conv3x3_train_kernel"),
    ("conv3x3_train_mma_kernel", "conv3x3_train_kernel"),
    ("paged_verify_kernel", "paged_verify_kernel"),
    ("paged_verify_split_kernel", "paged_verify_kernel"),
    ("paged_verify_combine_kernel", "paged_verify_kernel"),
    ("paged_decode_kernel", "paged_decode_kernel"),
    ("paged_decode_split_kernel", "paged_decode_kernel"),
    ("paged_decode_combine_kernel", "paged_decode_kernel"),
    ("sum_rows_kernel", "sum_rows_kernel"),
    ("shortseq_fwd_mma_kernel", "shortseq_fwd_kernel"),
    ("causal_fwd_mma_kernel", "causal_fwd_kernel")])
def test_profile_family_of_conv_and_forward_kernels(kernel, family):
    defined = set()
    for path in Path(CSRC).iterdir():
        text = re.sub(r"__launch_bounds__\([^)]*\)", "", path.read_text())
        defined.update(re.findall(r"__global__\s+void\s+(\w+)\s*\(", text))
    assert kernel in defined
    assert CHIP_SMOKE.kernel_family(_profiled_name(kernel)) == family


def test_profile_family_of_library_kernels():
    assert CHIP_SMOKE.kernel_family(
        "sm90_xmma_wgrad_implicit_gemm_indexed_bf16") == "cudnn conv"
    assert CHIP_SMOKE.kernel_family("nvjet_tst_128x64_64x4") == "gemm"
    assert CHIP_SMOKE.kernel_family("Memcpy DtoD", "gpu_memcpy") == \
        "gpu_memcpy"
    assert CHIP_SMOKE.kernel_family("vectorized_elementwise_kernel") == \
        "other kernels"


def test_conv_libraries_list_the_mma_headers():
    """Both conv libraries run bf16 kernels on the tensor cores: each
    includes `conv_mma.cuh` (and through it `attention_mma.cuh`) and lists
    both, with `conv_common.cuh`, so that a change to a header rebuilds
    it."""
    for lib in ("conv_bn_relu", "conv_bn_relu_bwd"):
        assert {"conv_common.cuh", "conv_mma.cuh",
                "attention_mma.cuh"} == _included(lib)
        assert _included(lib) <= set(KERNEL_SOURCES[lib])
        assert lib in MMA_KERNELS


def test_split_walk_range_is_the_wrappers():
    """The split walk's range length in its shared source is the one both
    wrappers size the partials with (the launches also refuse another),
    and the decode and verify libraries both take the walk from it."""
    from paddle_tpu_torch.ops import paged_decode, paged_verify

    assert paged_decode.RANGE_KEYS == paged_verify.RANGE_KEYS
    text = (Path(CSRC) / "paged_split.cuh").read_text()
    assert re.search(rf"constexpr int kRangeKeys = {paged_decode.RANGE_KEYS};",
                     text)
    for lib in ("paged_decode", "paged_verify"):
        assert "paged_split.cuh" in _included(lib)
        assert lib in CHIP_SMOKE.FMA_LIBS
        assert "kRangeKeys =" not in (Path(CSRC) / f"{lib}.cu").read_text()
    assert {"paged_verify_split_kernel", "paged_verify_combine_kernel",
            "paged_verify_kernel"} <= _globals("paged_verify")
    assert {"paged_decode_split_kernel", "paged_decode_combine_kernel",
            "paged_decode_kernel"} <= _globals("paged_decode")


@pytest.mark.parametrize("lib,rows", [("paged_decode", "1"),
                                      ("paged_verify", "kMaxW")])
def test_split_walk_kernels_are_thin(lib, rows):
    """Each library's split kernels only call the shared bodies, at its own
    row count (decode at one row, verify at the widest window): the walk
    itself, its ring and its shuffles live in paged_split.cuh alone."""
    text = (Path(CSRC) / f"{lib}.cu").read_text()
    assert f"paged_split::walk<T, P, D, {rows}>(" in text
    assert f"paged_split::combine<T, D, {rows}>(" in text
    for mark in ("cp_async", "extern __shared__", "Tile<", "unpack("):
        assert mark not in text, (lib, mark)


@pytest.mark.parametrize("bs", [8, 16, 32, 64])
def test_split_ranges_cover_the_table(bs):
    """The grid's ranges cover every key a table can reach, with the last
    range starting inside the table."""
    from paddle_tpu_torch.ops.paged_decode import RANGE_KEYS, split_ranges

    for maxb in (1, 7, 8, 2048 // bs, 4096 // bs + 1):
        nr = split_ranges(maxb, bs)
        assert (nr - 1) * RANGE_KEYS < maxb * bs <= nr * RANGE_KEYS


@pytest.mark.parametrize("lib,kernels", [
    ("grad_merge", {"grad_merge_kernel", "grad_finish_kernel",
                    "grad_unscale_kernel"}),
    ("optimizer_update", {"optimizer_update_kernel", "optimizer_norms_kernel",
                          "optimizer_norms_reduce_kernel"})])
def test_training_libraries_are_held_to_no_atomic_and_no_spill(lib, kernels):
    """Gradient merge's library and the one-pass update (with Lars' and
    Lamb's norm pass) share one header, the table walk, and are in
    `FMA_LIBS` (the build phase fails on an atomic or a spill in them);
    their sources hold no atomic (the flag is a plain store of 1, the
    norms sum in a fixed order) and every kernel the wrappers launch."""
    assert KERNEL_SOURCES[lib] == (f"{lib}.cu", "table_walk.cuh")
    assert _included(lib) == {"table_walk.cuh"}
    assert lib in CHIP_SMOKE.FMA_LIBS and lib in CHIP_SMOKE.SPILL_FREE_LIBS
    for src in KERNEL_SOURCES[lib]:
        text = (Path(CSRC) / src).read_text()
        assert not re.search(r"\batomic\w*\s*\(", text)
    assert kernels <= _globals(lib)


def test_table_walk_row_is_the_wrappers():
    """The table's row as the kernels walk it (table_walk.cuh) is the row
    the host builds (`_rows`, for `_Table`): kRow int64, the count at
    kNumel, the first block at kFirst, the word at kWord, up to five
    pointers around them; and neither library redefines the walk's
    constants."""
    from paddle_tpu_torch.ops.optimizer_update import _rows

    text = (Path(CSRC) / "table_walk.cuh").read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"\b(k\w+) = (\d+)[,;]", text)}
    assert (consts["kRow"], consts["kNumel"], consts["kFirst"],
            consts["kWord"]) == (8, 4, 5, 6)
    for lib in ("optimizer_update", "grad_merge"):
        src = (Path(CSRC) / f"{lib}.cu").read_text()
        assert not re.search(r"constexpr int k(Row|Chunk|Threads|Unroll)\b",
                             src), f"{lib} redefines the walk's constants"
    rows, blocks = _rows([(5000, [11, 12, 13], 7), (0, [21, 22], 0),
                          (2048, [31, 32, 33, 34, 35], 9)], 2048)
    assert rows == [[11, 12, 13, 0, 5000, 0, 7, 0],
                    [31, 32, 33, 34, 2048, 3, 9, 35]]
    assert blocks == 4
    assert all(len(r) == consts["kRow"] for r in rows)


def test_optimizer_wrapper_and_kernel_agree_on_rules_and_scalars():
    """The kernel's `Kind` enumeration and `Hyper` fields are the
    wrapper's `KINDS` and `_HYPER`, in order."""
    from paddle_tpu_torch.ops import optimizer_update as ou

    text = (Path(CSRC) / "optimizer_update.cu").read_text()
    enum = re.search(r"enum Kind \{([^}]*)\}", text).group(1)
    codes = dict((k.strip(), int(v)) for k, v in
                 re.findall(r"(k\w+)\s*=\s*(\d+)", enum))
    assert sorted(codes.values()) == sorted(ou.KINDS.values())
    names = {"adamw": "kAdamW", "adam": "kAdam", "momentum": "kMomentum",
             "sgd": "kSgd", "adagrad": "kAdagrad", "rmsprop": "kRmsprop",
             "adadelta": "kAdadelta", "lars": "kLars", "lamb": "kLamb"}
    assert {k: codes[names[k]] for k in ou.KINDS} == ou.KINDS
    body = re.search(r"struct Hyper \{(.*?)\};", text, re.S).group(1)
    fields = re.findall(r"(\w+)[,;]", re.sub(r"//[^\n]*", "", body))
    assert tuple(f for f in fields if f != "flag") == ou._HYPER
    assert re.search(rf"constexpr int kHyper = {len(ou._HYPER)};", text)
