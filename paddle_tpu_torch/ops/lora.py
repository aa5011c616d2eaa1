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
  `add` per site and layer. Under tensor parallel each shard has its own
  (`head_major=True`), over its B columns: the kernel launches once a
  shard a site.
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


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = cpp_extension.load("lora").batched_lora
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, I, P]
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
    B, S, in_dim = x.shape
    P, L, R = a.shape[:3]
    out_dim = base.shape[-1]
    heads, D = (b.shape[3], b.shape[5]) if b.dim() == 6 else (0, 0)
    dt = x.dtype
    if dt not in _DTYPE_CODE:
        raise ValueError(f"batched_lora: dtype {dt} has no kernel "
                         "(bfloat16 or float32)")
    if base.dtype != dt or a.dtype != dt or b.dtype != dt:
        raise ValueError("batched_lora: x, base and the factors must share "
                         "one dtype")
    if scaling.dtype != torch.float32 or rows.dtype != torch.int32:
        raise ValueError("batched_lora: scaling must be f32, rows int32")
    if not 1 <= R <= LORA_MAX_RANK:
        raise ValueError(f"batched_lora: max_rank {R} outside [1, "
                         f"{LORA_MAX_RANK}]")
    if (a.dim() != 4 or a.shape[3] != in_dim or b.shape[:3] != a.shape[:3]
            or b.numel() != P * L * R * out_dim
            or base.shape != (B, S, out_dim) or rows.shape != (B,)
            or scaling.shape != (P,) or not 0 <= layer < L):
        raise ValueError(
            f"batched_lora: shapes do not agree: x {tuple(x.shape)}, base "
            f"{tuple(base.shape)}, a {tuple(a.shape)}, b {tuple(b.shape)}, "
            f"rows {tuple(rows.shape)}, scaling {tuple(scaling.shape)}, "
            f"layer {layer}")
    ts = (base, x, a, b, rows, scaling)
    if any(t.device != base.device for t in ts):
        raise ValueError("batched_lora: every operand on base's device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("batched_lora: every operand must be contiguous")
    xp, ap, bp = x.data_ptr(), a.data_ptr(), b.data_ptr()
    # vector loads in the shrink and the expand where the rows allow them
    vec = int(in_dim % 8 == 0 and xp % 16 == 0 and ap % 16 == 0)
    bvec = int(out_dim % 4 == 0 and D % 4 == 0 and bp % 16 == 0)
    batched_lora.launches += 1
    err = _kernel()(xp, ap, bp, rows.data_ptr(), scaling.data_ptr(),
                    base.data_ptr(), B, S, in_dim, out_dim, R, L, layer,
                    heads, D, _DTYPE_CODE[dt], vec, bvec,
                    torch.cuda.current_stream(base.device).cuda_stream)
    if err:
        raise RuntimeError(f"batched_lora kernel launch failed: CUDA error "
                           f"{err}")
    return base


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

    def _factors(self, site):
        b_qkv = self.b_qkv.flatten(3) if self.head_major else self.b_qkv
        return {"qkv": (self.a_qkv, b_qkv),
                "out": (self.a_out, self.b_out),
                "fc1": (self.a_fc1, self.b_fc1),
                "fc2": (self.a_fc2, self.b_fc2)}[site]

    def qkv_delta(self, x, layer, head_major):
        return lora_qkv_delta(x, self.a_qkv, self.b_qkv, self.rows,
                              self.scaling, layer, head_major)

    def linear_delta(self, site, x, layer):
        a, b = self._factors(site)
        return lora_linear_delta(x, a, b, self.rows, self.scaling, layer)

    def add(self, site, base, x, layer):
        """`base += site's delta of x` at `layer` (`batched_lora`): base
        `[B, S, out]` (qkv 3-major), x `[B, S, in]`. Returns base."""
        a, b = self._factors(site)
        return batched_lora(base, x.contiguous(), a, b, self.rows,
                            self.scaling, layer)
