"""Per-row categorical sampling and rejection-sampling speculative
acceptance: counterpart of paddle_tpu/ops/sampling.py, function for
function, with the draws as hand-written kernels (`csrc/sampling.cu`).

Per-slot parameters (temperature, top-k, top-p) arrive as per-row tensors,
so one step serves any mix of greedy and sampled lanes. Greedy rows
(`temperature <= 0`) take the literal argmax, the same op over the same
logits as a `sampling=False` engine, so their tokens are bit-identical to
it. Randomness is keyed per (request seed, absolute position): each slot's
base key row (`inference.sampling.key_row`, `[N, 2]` uint32 values in
int64) has the row's position and then a draw-purpose salt folded into it,
`fold_in(fold_in(key, position), salt)`, as jax folds them, and the bits
under that key are jax's (`ops/threefry.py`), so the port draws the JAX
engine's tokens from the same logits.

`verify_window` is the rejection-sampling acceptance over a speculative
window. The drafters are deterministic (q a point mass), so the accept
test `u < min(1, p(x) / q(x))` is `u < p(x)` and the residual resample
`norm(max(p - q, 0))` is p with the rejected draft's mass removed: the
emitted stream keeps the target distribution. Greedy lanes test argmax
equality and pin every choice to the argmax.

The draws are kernels. `sample_draw` is one categorical draw a row by the
Gumbel-max trick, `argmax(gumbel(key, V) + logits)` (jax.random's
`categorical`), with an optional excluded index a row (the residual
resample's -inf, without a second `[N, V]` tensor). `verify_draws` is the
verify step's two draws in one launch: that draw, and the acceptance coin,
one U[0, 1) a row under the same key rows and positions with the coin's
salt (JAX computes both inside one compiled verify program). On a CPU
tensor each runs its plain versions (`sample_draw_plain`,
`sample_uniform_plain`: the same arithmetic in torch ops over
`ops.threefry`); on a CUDA tensor it launches its kernel or raises. Each
counts `.launches`; `.plain_calls` counts the plain versions' calls on any
device (`sample_draw_plain`'s under `sample_draw`, `sample_uniform_plain`'s
under `verify_draws`). The draw's kernel splits each row over the CTAs of
a thread-block cluster; `_draw_cluster` is its launch plan, here so that
the CPU tests can pin it.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..utils import cpp_extension
from .threefry import fold_in, gumbel, uniform

__all__ = ["masked_logits", "sample_token", "verify_window", "SALT_SAMPLE",
           "SALT_ACCEPT", "sample_draw", "verify_draws",
           "sample_draw_plain", "sample_uniform_plain"]

#: draw-purpose salts folded into the per-(slot, position) key: the
#: categorical draw (plain sample, speculative bonus, rejection resample:
#: exclusive uses of one row, so they share a stream) and the acceptance
#: uniform must be independent
SALT_SAMPLE = 0
SALT_ACCEPT = 1

_SMS = 132                  # the H100 SXM's streaming multiprocessors
_MAX_CLUSTER = 16           # the largest (non-portable) cluster


@functools.lru_cache(maxsize=None)
def _draw_cluster(N):
    """The CTAs of the cluster that shares a row of the draw: about two
    CTAs an SM over the N rows, `2 * 132 / N` rounded to the nearest power
    of two, 1 to 16 (16 at the decode step's N 8, 8 at the verify step's
    N 40). From N alone: the token never depends on it."""
    c = 2 ** round(math.log2(2 * _SMS / max(N, 1)))
    return max(1, min(_MAX_CLUSTER, c))


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = cpp_extension.load("sampling")
    P, I = ctypes.c_void_p, ctypes.c_int
    draw, coin = lib.sample_draw, lib.sample_draw_coin
    draw.argtypes = [P, P, P, P, I, I, I, I, P, P]
    coin.argtypes = [P, P, P, P, I, I, I, I, I, P, P, P]
    draw.restype = coin.restype = I
    return draw, coin


def _row_keys(key_rows, positions, salt):
    """Each row's draw key, `fold_in(fold_in(key_row, position), salt)`."""
    key = fold_in((key_rows[:, 0], key_rows[:, 1]), positions.long())
    return fold_in(key, salt)


def sample_draw_plain(lg, key_rows, positions, salt, exclude=None):
    """One categorical draw a row of the fp32 logits `lg` `[N, V]`:
    `argmax(gumbel(key, V) + lg)`, the lowest index on a tie, with
    `exclude[i]` (-1 for none) taken out of row i. Returns `[N]` int32."""
    sample_draw.plain_calls += 1
    V = lg.shape[1]
    if exclude is not None:
        col = torch.arange(V, device=lg.device)
        lg = torch.where(col[None] == exclude.long()[:, None],
                         torch.full((), -torch.inf, device=lg.device), lg)
    g = gumbel(_row_keys(key_rows, positions, salt), V)
    return torch.argmax(g + lg, -1).to(torch.int32)


def sample_uniform_plain(key_rows, positions, salt):
    """One U[0, 1) a row, jax.random.uniform under the row's key: `[N]`
    f32. The plain version of the coin in `verify_draws`' launch."""
    verify_draws.plain_calls += 1
    return uniform(_row_keys(key_rows, positions, salt), 1)[:, 0]


def _check_rows(name, key_rows, positions, N, dev):
    if key_rows.dtype != torch.int64 or tuple(key_rows.shape) != (N, 2) \
            or not key_rows.is_contiguous() or key_rows.device != dev:
        raise ValueError(f"{name}: key_rows must be contiguous int64 "
                         f"[{N}, 2] on {dev}")
    if positions.dtype != torch.int32 or tuple(positions.shape) != (N,) \
            or not positions.is_contiguous() or positions.device != dev:
        raise ValueError(f"{name}: positions must be contiguous int32 "
                         f"[{N}] on {dev}")


def _check_draw(name, lg, key_rows, positions, exclude):
    if lg.dtype != torch.float32 or lg.dim() != 2 or not lg.is_contiguous():
        raise ValueError(f"{name}: logits must be contiguous float32 [N, V]")
    N = lg.shape[0]
    _check_rows(name, key_rows, positions, N, lg.device)
    if exclude is not None and (
            exclude.dtype != torch.int32 or tuple(exclude.shape) != (N,)
            or not exclude.is_contiguous() or exclude.device != lg.device):
        raise ValueError(f"{name}: exclude must be contiguous int32 "
                         f"[{N}] on {lg.device}")


def _launched(err, what):
    if err:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def sample_draw(lg, key_rows, positions, salt, exclude=None):
    """`sample_draw_plain` on a CPU tensor; on a CUDA one, one launch of
    `sample_draw_kernel` (a cluster of `_draw_cluster(N)` CTAs a row) or a
    ValueError for what it does not take: fp32 contiguous logits `[N, V]`,
    int64 `[N, 2]` key rows, int32 `[N]` positions and exclusions."""
    if lg.device.type == "cpu":
        return sample_draw_plain(lg, key_rows, positions, salt, exclude)
    _check_draw("sample_draw", lg, key_rows, positions, exclude)
    N, V = lg.shape
    out = torch.empty(N, dtype=torch.int32, device=lg.device)
    sample_draw.launches += 1
    _launched(_kernels()[0](
        lg.data_ptr(), key_rows.data_ptr(), positions.data_ptr(),
        None if exclude is None else exclude.data_ptr(), int(salt), N, V,
        _draw_cluster(N), out.data_ptr(),
        torch.cuda.current_stream(lg.device).cuda_stream),
        "sample_draw")
    return out


def verify_draws(lg, key_rows, positions, exclude=None):
    """The verify step's two draws a row: `(sample_draw_plain(lg, key_rows,
    positions, SALT_SAMPLE, exclude), sample_uniform_plain(key_rows,
    positions, SALT_ACCEPT))` on a CPU tensor; on a CUDA one, one launch of
    `sample_draw_coin_kernel` (the draw's cluster plan, rank 0 of each row
    also writing its coin), or a ValueError for what `sample_draw` does not
    take. Returns (`[N]` int32 tokens, `[N]` f32 coins)."""
    if lg.device.type == "cpu":
        return (sample_draw_plain(lg, key_rows, positions, SALT_SAMPLE,
                                  exclude),
                sample_uniform_plain(key_rows, positions, SALT_ACCEPT))
    _check_draw("verify_draws", lg, key_rows, positions, exclude)
    N, V = lg.shape
    out = torch.empty(N, dtype=torch.int32, device=lg.device)
    u = torch.empty(N, dtype=torch.float32, device=lg.device)
    verify_draws.launches += 1
    _launched(_kernels()[1](
        lg.data_ptr(), key_rows.data_ptr(), positions.data_ptr(),
        None if exclude is None else exclude.data_ptr(), SALT_SAMPLE,
        SALT_ACCEPT, N, V, _draw_cluster(N), out.data_ptr(), u.data_ptr(),
        torch.cuda.current_stream(lg.device).cuda_stream),
        "verify_draws")
    return out, u


for _w in (sample_draw, verify_draws):
    _w.launches = 0
    _w.plain_calls = 0
del _w


def masked_logits(logits, temps, top_ks, top_ps):
    """Temperature, top-k and top-p masking: `logits` `[N, V]` and per-row
    `temps`, `top_ks`, `top_ps` `[N]` -> fp32 logits whose softmax is each
    row's sampling distribution: scaled by 1 / temperature, everything
    below the k-th largest scaled logit at -inf (`top_k <= 0` is off),
    then the nucleus, ranked by descending probability, keeping a token
    iff the mass before it is < `top_p` (the argmax always stays). Greedy
    rows are scaled by 1.0; callers never select them. One stable
    descending sort serves both masks, and a scatter un-permutes."""
    lg = logits.float()
    N, V = lg.shape
    neg = torch.full((), -torch.inf, device=lg.device)
    safe_t = torch.where(temps <= 0.0, torch.ones((), device=lg.device),
                         temps.float())
    lg = lg / safe_t[:, None]
    order = torch.argsort(-lg, dim=-1, stable=True)
    desc = torch.gather(lg, 1, order)
    k = torch.where(top_ks <= 0, V, top_ks).long()
    kth = torch.gather(desc, 1, torch.clamp(k - 1, 0, V - 1)[:, None])
    lg = torch.where(lg >= kth, lg, neg)
    p_desc = torch.softmax(torch.where(desc >= kth, desc, neg), -1)
    cum = torch.cumsum(p_desc, -1)
    keep_desc = (cum - p_desc) < top_ps.float()[:, None]
    keep_desc[:, 0] = True                     # the argmax always survives
    keep = torch.zeros((N, V), dtype=torch.bool, device=lg.device) \
        .scatter(1, order, keep_desc)
    return torch.where(keep, lg, neg)


def sample_token(logits, temps, top_ks, top_ps, key_rows, positions):
    """Per-row next token of `[N, V]` logits: greedy rows the argmax,
    sampled rows one draw from the masked distribution under the row's
    (seed, position) key; `positions` `[N]` int32 are the absolute
    positions whose logits these are. Returns `[N]` int32."""
    am = torch.argmax(logits, -1).to(torch.int32)
    lg = masked_logits(logits, temps, top_ks, top_ps)
    drawn = sample_draw(lg, key_rows, positions, SALT_SAMPLE)
    return torch.where(temps <= 0.0, am, drawn)


def verify_window(logits, tokens, draft_lens, temps, top_ks, top_ps,
                  key_rows, positions):
    """Rejection-sampling acceptance over one speculative verify window.

    `logits` `[B, W, V]` (row j's distribution governs the token after
    row j), `tokens` `[B, W]` (the feed token, then the drafts),
    `draft_lens` `[B]`, per-slot `temps`/`top_ks`/`top_ps` `[B]`,
    `key_rows` `[B, 2]`, `positions` `[B]` int32 (row 0's absolute
    position). Returns

    - `choices` `[B, W]` int32: the token to emit when the acceptance walk
      stops at row j: a draw from p_j without the draft's token while a
      draft follows row j (the residual resample), from p_j whole at
      j == draft_len (the bonus draw, the same (position, salt) stream a
      K=0 step would take); greedy lanes the argmax;
    - `accepts` `[B, W]` bool: row j tests the draft in row j + 1, the
      coin `u < p_j(d)` on sampled lanes and argmax equality on greedy
      ones; False past the draft.

    The caller accepts the longest prefix `n` of true `accepts` and emits
    `drafts[:n] + [choices[n]]`."""
    B, W, V = logits.shape
    dev = logits.device
    am = torch.argmax(logits, -1).to(torch.int32)
    rep = functools.partial(torch.repeat_interleave, repeats=W, dim=0)
    lg = masked_logits(logits.reshape(B * W, V), rep(temps), rep(top_ks),
                       rep(top_ps))
    probs = torch.softmax(lg, -1).view(B, W, V)
    d_next = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                       1).to(torch.int32)
    col = torch.arange(W, device=dev, dtype=torch.int32)
    has_draft = col[None] < draft_lens[:, None]
    p_d = torch.gather(probs, 2, d_next.long()[..., None])[..., 0]
    wpos = (positions[:, None] + col[None]).reshape(-1)
    exclude = torch.where(has_draft, d_next, -1).reshape(-1)
    drawn, u = verify_draws(lg, rep(key_rows), wpos, exclude)
    greedy = (temps <= 0.0)[:, None]
    accepts = torch.where(greedy, d_next == am, u.view(B, W) < p_d) \
        & has_draft
    drawn = drawn.view(B, W)
    return torch.where(greedy, am, drawn), accepts
