"""Batched paged LoRA: counterpart of paddle_tpu/ops/lora.py, the op tier
under the multi-tenant adapter subsystem (`paddle_tpu_torch/adapters/`).

Every serving slot may carry a different tenant adapter, and one step
serves any tenant mix. The factors live in a paged pool
(`adapters.PagedAdapterPool`), stacked per target site:

- `a_<site>`: `[pages, layers, max_rank, in]`, the LoRA A factors, rank
  rows past an adapter's rank exact zeros;
- `b_<site>`: `[pages, layers, max_rank, ...out layout]`: `b_qkv` is
  head-grouped `[.., heads, 3, head_dim]`, the linear sites `[.., out]`;
- `scaling`: `[pages]` f32, each adapter's `alpha / rank`.

Page 0 is the null adapter (zero factors, zero scaling): a base-model
slot's delta is exact zeros.

The delta is `(x . A^T . B^T) * scaling[page]`, both products accumulated
in fp32 and the scaling applied in fp32, cast to `x.dtype` once, then
added to the base projection's output in `x.dtype`: two roundings, as JAX
adds `delta.astype(dtype)` to its base.

- `lora_linear_delta`, `lora_qkv_delta`: JAX's functions, plain torch over
  gathered factors (the einsums JAX leaves to XLA).
- `batched_lora(base, x, a, b, rows, scaling, layer)`: `base + delta` for
  one site and one layer, the base updated IN PLACE. On a CPU tensor it
  runs its plain version (`batched_lora_plain`, the delta functions then
  the add); on a CUDA tensor it launches the hand-written kernel of
  `csrc/lora.cu`, which reads each slot's factors where they lie in the
  pool, or raises. It counts `.launches` and `.plain_calls`.
- `LoraState`: one step's view of the pool, the pool tensors plus the
  per-slot `[slots]` int32 page row; the model's serving forwards call
  `add` per site and layer. On the card it checks the pool and the rows
  once (`_Site`), and `add` checks only x, base and the layer. Under
  tensor parallel each shard has its own (`head_major=True`), over its B
  columns: the kernel launches once a shard a site.

The kernel splits a slot's shrink over the CTAs of a thread-block
cluster; `_plan` is its launch plan, here so that the CPU tests can pin
it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import cpp_extension

__all__ = ["LORA_SITES", "LoraState", "lora_linear_delta", "lora_qkv_delta",
           "batched_lora", "batched_lora_plain", "LORA_MAX_RANK"]

#: The base-model matmuls an adapter may target, in pool-array order.
LORA_SITES = ("qkv", "out", "fc1", "fc2")

#: The largest `max_rank` the kernel takes.
LORA_MAX_RANK = 64

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _gather(a, b, rows, scaling, layer):
    r = rows.long()
    return a[r, layer].float(), b[r, layer].float(), scaling[r].float()


def lora_linear_delta(x, a, b, rows, scaling, layer):
    """Per-slot low-rank delta for one linear site, one layer.

    x `[B, S, in]`, the activation the base matmul consumes; a `[pages,
    layers, max_rank, in]`; b `[pages, layers, max_rank, out]`; rows `[B]`
    int32 page per slot (0 the null adapter); scaling `[pages]` f32; layer
    a host int. Returns `[B, S, out]` in x.dtype: `(x . A^T . B^T) *
    scaling`, fp32-accumulated, exact zeros for null and rank-padded
    rows."""
    al, bl, s = _gather(a, b, rows, scaling, layer)
    xr = torch.einsum("bsi,bri->bsr", x.float(), al)
    d = torch.einsum("bsr,bro->bso", xr, bl)
    return (d * s[:, None, None]).to(x.dtype)


def lora_qkv_delta(x, a, b, rows, scaling, layer, head_major):
    """The qkv site's delta: b head-grouped `[pages, layers, max_rank,
    heads, 3, D]`. `head_major=True` returns `[B, S, heads, 3, D]`, False
    the 3-major `[B, S, 3, heads, D]` that the base qkv projection's
    output views as."""
    al, bl, s = _gather(a, b, rows, scaling, layer)
    out = "bshtd" if head_major else "bsthd"
    xr = torch.einsum("bsi,bri->bsr", x.float(), al)
    d = torch.einsum(f"bsr,brhtd->{out}", xr, bl)
    return (d * s[:, None, None, None, None]).to(x.dtype)


_MAX_CLUSTER = 8            # the portable cluster size
_MIN_SHARE = 128            # inputs a rank of the cluster at least
_MAX_TILE = 16              # rows of one slot a cluster
_THREADS = 256
_MAX_SEG = 32               # a warp's lanes


@functools.lru_cache(maxsize=None)
def _plan(in_dim, R, S):
    """The kernel's launch plan `(cluster, tile_rows, segments)` for x
    `[B, S, in_dim]` under rank-R pages: `cluster` CTAs share in_dim (the
    largest power of two up to 8 that leaves each at least 128 inputs: 8
    at GPT-1.3B's 2048 and 8192; 16 ran slower at the decode and verify
    steps on an H100, PERF.md), `tile_rows` of a slot a cluster (all of
    them up to 16: the decode and verify steps' 1 and 5 rows in one tile,
    a 128-row prefill chunk over 8 clusters, 64 CTAs), and the shrink's
    `segments` a 4 x 4 tile of (rows, ranks) (a power of two up to 32,
    the tiles' threads at most 256). From (in_dim, R, S) alone, never from
    out_dim or the dtype: a
    tensor-parallel shard (the same x and A, out / mp columns of B) then
    sums each xr in the whole launch's order, and a bf16 launch in an f32
    launch's."""
    cluster = 1
    while cluster < _MAX_CLUSTER and in_dim >= 2 * cluster * _MIN_SHARE:
        cluster *= 2
    tile = min(S, _MAX_TILE)
    tiles = -(-tile // 4) * -(-R // 4)
    seg = 1
    while seg < _MAX_SEG and 2 * seg * tiles <= _THREADS:
        seg *= 2
    return cluster, tile, seg


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = cpp_extension.load("lora").batched_lora
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, P] + [I] * 15 + [P]
    fn.restype = I
    return fn


def _site_delta(x, a, b, rows, scaling, layer):
    """The delta in the base output's flat layout `[B, S, out]` (qkv
    3-major)."""
    if b.dim() == 6:
        d = lora_qkv_delta(x, a, b, rows, scaling, layer, head_major=False)
        return d.reshape(*x.shape[:2], -1)
    return lora_linear_delta(x, a, b, rows, scaling, layer)


def batched_lora_plain(base, x, a, b, rows, scaling, layer):
    """Plain version of the kernel: `base += delta.to(base.dtype)` with
    the delta from `lora_qkv_delta` (b 6-D, head-grouped; base the 3-major
    `[B, S, 3 * heads * D]`) or `lora_linear_delta`. Returns base."""
    batched_lora.plain_calls += 1
    return base.add_(_site_delta(x, a, b, rows, scaling, layer))


class _Site:
    """One site's pool tensors as the kernel takes them: checked, with
    their pointers, the dtype's code and whether A's and B's rows allow
    bulk and 16-byte copies, once for every call over them. A ValueError
    for what the kernel does not take."""

    def __init__(self, a, b, scaling):
        dt = a.dtype
        if dt not in _DTYPE_CODE:
            raise ValueError(f"batched_lora: dtype {dt} has no kernel "
                             "(bfloat16 or float32)")
        if b.dtype != dt:
            raise ValueError("batched_lora: x, base and the factors must "
                             "share one dtype")
        if scaling.dtype != torch.float32:
            raise ValueError("batched_lora: scaling must be f32, rows "
                             "int32")
        if a.dim() != 4 or b.dim() not in (4, 6):
            raise ValueError(f"batched_lora: shapes do not agree: a "
                             f"{tuple(a.shape)}, b {tuple(b.shape)}")
        P, L, R, in_dim = a.shape
        if not 1 <= R <= LORA_MAX_RANK:
            raise ValueError(f"batched_lora: max_rank {R} outside [1, "
                             f"{LORA_MAX_RANK}]")
        if b.shape[:3] != a.shape[:3] or scaling.shape != (P,):
            raise ValueError(
                f"batched_lora: shapes do not agree: a {tuple(a.shape)}, b "
                f"{tuple(b.shape)}, scaling {tuple(scaling.shape)}")
        if b.device != a.device or scaling.device != a.device:
            raise ValueError("batched_lora: every operand on base's device")
        if not (a.is_contiguous() and b.is_contiguous()
                and scaling.is_contiguous()):
            raise ValueError("batched_lora: every operand must be contiguous")
        self.device, self.dtype, self.code = a.device, dt, _DTYPE_CODE[dt]
        self.L, self.R, self.in_dim = L, R, in_dim
        self.out_dim = b.numel() // (P * L * R)
        self.heads, self.D = (b.shape[3], b.shape[5]) if b.dim() == 6 \
            else (0, 0)
        self.a, self.b, self.s = a.data_ptr(), b.data_ptr(), \
            scaling.data_ptr()
        self.index = a.device.index
        esz = a.element_size()
        # bulk copies of A's rows, 16-byte copies of B's
        self.avec = in_dim % 8 == 0 and self.a % 16 == 0
        self.bvec = int(self.out_dim * esz % 16 == 0 and self.b % 16 == 0)
        self.fn = _kernel()

    def launch(self, base, x, rows, layer):
        """`base += delta`: one launch over x and base, whose dtypes,
        shapes, device and layout are checked here, as is the layer; rows
        must be the step's checked `[B]` int32 pages."""
        if x.dtype != self.dtype or base.dtype != self.dtype:
            raise ValueError("batched_lora: x, base and the factors must "
                             "share one dtype")
        if x.dim() != 3 or x.shape[2] != self.in_dim \
                or base.shape != (*x.shape[:2], self.out_dim) \
                or rows.shape != x.shape[:1] or not 0 <= layer < self.L:
            raise ValueError(
                f"batched_lora: shapes do not agree: x {tuple(x.shape)}, "
                f"base {tuple(base.shape)}, rows {tuple(rows.shape)}, "
                f"in {self.in_dim}, out {self.out_dim}, layer {layer} of "
                f"{self.L}")
        if x.device != self.device or base.device != self.device:
            raise ValueError("batched_lora: every operand on base's device")
        if not (x.is_contiguous() and base.is_contiguous()):
            raise ValueError("batched_lora: every operand must be contiguous")
        B, S = x.shape[:2]
        xp = x.data_ptr()
        cluster, tile, seg = _plan(self.in_dim, self.R, S)
        batched_lora.launches += 1
        err = self.fn(xp, self.a, self.b, rows.data_ptr(), self.s,
                      base.data_ptr(), B, S, self.in_dim, self.out_dim,
                      self.R, self.L, layer, self.heads, self.D, self.code,
                      int(self.avec and xp % 16 == 0), self.bvec, cluster,
                      tile, seg,
                      torch._C._cuda_getCurrentRawStream(self.index))
        if err:
            raise RuntimeError(f"batched_lora kernel launch failed: CUDA "
                               f"error {err}")
        return base


def _check_rows(rows, device):
    if rows.dtype != torch.int32 or rows.dim() != 1 \
            or not rows.is_contiguous():
        raise ValueError("batched_lora: scaling must be f32, rows int32")
    if rows.device != device:
        raise ValueError("batched_lora: every operand on base's device")


def batched_lora(base, x, a, b, rows, scaling, layer):
    """`base [B, S, out] += (x [B, S, in] . A^T . B^T) * scaling`, per slot
    from page `rows[slot]` of the pool at `layer`, IN PLACE; returns base.
    b is `[pages, layers, R, out]`, or for the qkv site head-grouped
    `[pages, layers, R, heads, 3, D]` with base 3-major. The plain version
    on a CPU tensor, one kernel launch on a CUDA one. The kernel takes
    bf16 or f32 x, base, a and b of one dtype, contiguous, R up to
    `LORA_MAX_RANK`; anything else raises a ValueError."""
    if base.device.type == "cpu":
        return batched_lora_plain(base, x, a, b, rows, scaling, layer)
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"batched_lora: dtype {x.dtype} has no kernel "
                         "(bfloat16 or float32)")
    site = _Site(a, b, scaling)
    _check_rows(rows, site.device)
    return site.launch(base, x, rows, layer)


batched_lora.launches = 0
batched_lora.plain_calls = 0


class LoraState:
    """One step's view of the adapter pool: the pool tensors (in
    `adapters.adapter_pool_spec` order) plus the per-slot `[B]` int32 page
    row, on the pool's device. Each of the B slots' pages repeats over the
    S rows of its slot (the verify window, a prefill's positions).

    `head_major=True` is one tensor-parallel shard's view: its B pages are
    the shard's output columns, and its qkv base is head-grouped
    (`[B, S, heads/mp * 3 * D]`, the engine's qkv grouping), the layout of
    its `b_qkv` slice, so that `add` takes the qkv site as a linear one
    over the flattened pages (JAX's `lora_qkv_delta(head_major=True)`)."""

    def __init__(self, arrays, rows, head_major=False):
        (self.a_qkv, self.b_qkv, self.a_out, self.b_out,
         self.a_fc1, self.b_fc1, self.a_fc2, self.b_fc2,
         self.scaling) = arrays
        self.rows = rows
        self.head_major = head_major
        b_qkv = self.b_qkv.flatten(3) if head_major else self.b_qkv
        self._factors = {"qkv": (self.a_qkv, b_qkv),
                       "out": (self.a_out, self.b_out),
                       "fc1": (self.a_fc1, self.b_fc1),
                       "fc2": (self.a_fc2, self.b_fc2)}
        # on the card: the pool and the rows checked once a step, not at
        # every one of the step's calls
        self._sites = None
        if rows.device.type != "cpu":
            _check_rows(rows, rows.device)
            self._sites = {site: _Site(a, b, self.scaling)
                           for site, (a, b) in self._factors.items()}

    def qkv_delta(self, x, layer, head_major):
        return lora_qkv_delta(x, self.a_qkv, self.b_qkv, self.rows,
                              self.scaling, layer, head_major)

    def linear_delta(self, site, x, layer):
        a, b = self._factors[site]
        return lora_linear_delta(x, a, b, self.rows, self.scaling, layer)

    def add(self, site, base, x, layer):
        """`base += site's delta of x` at `layer` (`batched_lora`): base
        `[B, S, out]` (qkv 3-major), x `[B, S, in]`. Returns base."""
        x = x.contiguous()
        if self._sites is None or base.device.type == "cpu":
            a, b = self._factors[site]
            return batched_lora(base, x, a, b, self.rows, self.scaling,
                                layer)
        return self._sites[site].launch(base, x, self.rows, layer)
