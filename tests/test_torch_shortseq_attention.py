"""Short-sequence (encoder) attention of the PyTorch port against the JAX
package, on the CPU.

The plain versions of the shortseq forward and backward kernels (what the
CUDA kernels' wrappers run on a CPU tensor), mask-free and key-masked, are
held against the JAX Pallas kernels themselves, run in interpret mode
(`_shortseq_call_fwd` / `_shortseq_call_bwd`; their `[BH, 8, S]` LSE and
mask rows are eight identical rows, the port's `[BH, S]` is row 0), at
S 128/256 and D 64/128, with padded tails and one all-padding sequence;
`shortseq_attention`'s autograd against `jax.grad` through JAX's
`shortseq_attention(interpret=True)`; and the routing of `flash_attention`
and `scaled_dot_product_attention` against JAX's. Same seeded numpy inputs
to both packages.

Tolerances: f32 within 1e-5; the backward per sequence within 4e-6 of that
sequence's largest |gradient| plus 1e-5 (an all-padding sequence has p = 1
on every key, so its gradients sum S unit-size terms, |g| up to ~75 at
S 256, and fp32 sums in another order differ in proportion); bf16
within 2e-2 (O), 1e-3 (LSE) and 1e-2 of the sequence's largest |gradient|
plus 1e-5 (a p or ds on a bf16 rounding boundary may round the other
way), the limits the card's kernels are held to.
"""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.nn_ops import scaled_dot_product_attention as j_sdpa
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops.nn_ops import scaled_dot_product_attention

# the module, not the function that paddle_tpu.ops.pallas re-exports
jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

B, H = 2, 2
FWD_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 1e-3)}   # O, LSE
BWD_TOL = {"float32": (4e-6, 1e-5), "bfloat16": (1e-2, 1e-5)}   # rel, abs
CASES = [(S, D, masked) for S in (128, 256) for D in (64, 128)
         for masked in (False, True)]


def _inputs(seed, S, D, n=3):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B * H, S, D).astype(np.float32) for _ in range(n))


def _key_mask(S, all_padding=True):
    """Additive fp32 key mask `[B, S]` at -1e30, as BertModel makes it:
    sequence 0 keeps S - 37 real tokens; sequence 1 keeps none (all
    padding) or, with `all_padding=False`, S // 2."""
    keep = np.array([S - 37, 0 if all_padding else S // 2])
    return np.where(np.arange(S)[None] < keep[:, None], 0.0,
                    -1e30).astype(np.float32)


def _jax_rows(km):
    """The TPU wrapper's mask layout: `[B, S]` repeated over heads and
    broadcast to `[BH, 8, S]`."""
    rows = np.repeat(km, H, axis=0)
    return jnp.broadcast_to(jnp.asarray(rows)[:, None, :],
                            (rows.shape[0], 8, rows.shape[1]))


def _jdt(dtype):
    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


def _tdt(dtype):
    return torch.bfloat16 if dtype == "bfloat16" else torch.float32


def _jax_fwd(q, k, v, km, scale, dtype):
    BH, S, D = q.shape
    jq, jk, jv = (jnp.asarray(x).astype(_jdt(dtype)) for x in (q, k, v))
    hb = jfa._shortseq_hb(BH, S, D, itemsize=jq.dtype.itemsize)
    o, lse = jfa._shortseq_call_fwd(jq, jk, jv,
                                    None if km is None else _jax_rows(km),
                                    scale, hb, interpret=True)
    return o, lse, hb


def _per_sequence_close(got, want, dtype):
    rel, floor = BWD_TOL[dtype]
    for g, w in zip(got, want):
        g = g.float().numpy()
        w = np.asarray(jnp.asarray(w).astype(jnp.float32))
        err = np.abs(g - w).max(axis=(1, 2))
        assert (err <= rel * np.abs(w).max(axis=(1, 2)) + floor).all(), \
            (err, np.abs(w).max(axis=(1, 2)))


@pytest.mark.parametrize("dtype,S,D,masked",
                         [("float32",) + c for c in CASES]
                         + [("bfloat16", 128, 64, True),
                            ("bfloat16", 256, 128, False)])
def test_plain_shortseq_forward_matches_jax_interpret_kernel(dtype, S, D,
                                                             masked):
    """O and LSE of `shortseq_attention_fwd` on CPU tensors (its plain
    version, no launch) against `_shortseq_call_fwd(interpret=True)`; with
    the mask, sequence 1 is all padding and both give the mean of v."""
    q, k, v = _inputs(S + D, S, D)
    km = _key_mask(S) if masked else None
    scale = 1.0 / math.sqrt(D)
    jo, jl, _ = _jax_fwd(q, k, v, km, scale, dtype)
    t = [torch.from_numpy(x).to(_tdt(dtype)) for x in (q, k, v)]
    launches = (tfa.shortseq_attention_fwd.launches,
                tfa.shortseq_attention_fwd.masked_launches)
    plain = tfa.shortseq_attention_fwd.plain_calls
    o, lse = tfa.shortseq_attention_fwd(
        *t, scale, None if km is None else torch.from_numpy(km))
    assert (tfa.shortseq_attention_fwd.launches,
            tfa.shortseq_attention_fwd.masked_launches) == launches
    assert tfa.shortseq_attention_fwd.plain_calls == plain + 1
    assert o.dtype == _tdt(dtype) and lse.shape == (B * H, S)
    assert lse.dtype == torch.float32
    otol, ltol = FWD_TOL[dtype]
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(jo.astype(jnp.float32)),
                               atol=otol, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl)[:, 0], atol=ltol,
                               rtol=0)
    if masked:
        mean = t[2][H:].float().mean(1, keepdim=True)
        np.testing.assert_allclose(o[H:].float().numpy(),
                                   mean.expand(H, S, D).numpy(), atol=otol,
                                   rtol=0)


@pytest.mark.parametrize("dtype,S,D,masked",
                         [("float32",) + c for c in CASES]
                         + [("bfloat16", 128, 64, True),
                            ("bfloat16", 256, 128, False)])
def test_plain_shortseq_backward_matches_jax_interpret_kernel(dtype, S, D,
                                                              masked):
    """dq, dk, dv of `shortseq_attention_bwd` on CPU tensors against
    `_shortseq_call_bwd(interpret=True)` on the same q, k, v, dO and the
    JAX forward's O and LSE. On the all-padding sequence both take p = 1
    per key (the JAX kernel's result, S times the dense one)."""
    q, k, v, do = _inputs(1000 + S + D, S, D, n=4)
    km = _key_mask(S) if masked else None
    scale = 1.0 / math.sqrt(D)
    jo, jl, hb = _jax_fwd(q, k, v, km, scale, dtype)
    jq, jk, jv, jdo = (jnp.asarray(x).astype(_jdt(dtype))
                       for x in (q, k, v, do))
    want = jfa._shortseq_call_bwd(jq, jk, jv,
                                  None if km is None else _jax_rows(km), jo,
                                  jdo, jl, scale, hb, interpret=True)
    t = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(_tdt(dtype))
         for x in (jq, jk, jv, jo, jdo)]
    plain = tfa.shortseq_attention_bwd.plain_calls
    got = tfa.shortseq_attention_bwd(
        *t, torch.from_numpy(np.asarray(jl)[:, 0].copy()), scale,
        None if km is None else torch.from_numpy(km))
    assert tfa.shortseq_attention_bwd.plain_calls == plain + 1
    assert all(g.dtype == _tdt(dtype) for g in got)
    _per_sequence_close(got, want, dtype)
    if masked:      # the all-padding sequence: dv = the column sums of dO
        dv_pad = t[4][H:].float().sum(1, keepdim=True).expand(H, S, D)
        np.testing.assert_allclose(got[2][H:].float().numpy(),
                                   dv_pad.numpy(), rtol=1e-2 if
                                   dtype == "bfloat16" else 1e-5, atol=1e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_shortseq_attention_grads_match_jax_grad(masked):
    """`shortseq_attention` in paddle layout (B2 S128 H2 D64, f32) against
    `jax.grad` through JAX's `shortseq_attention(interpret=True)`, with a
    `[B, S]` key mask that includes an all-padding sequence."""
    rng = np.random.RandomState(11)
    S, D = 128, 64
    q, k, v, do = (rng.randn(B, S, H, D).astype(np.float32)
                   for _ in range(4))
    km = _key_mask(S) if masked else None

    def jloss(a, b, c):
        out = jfa.shortseq_attention(a, b, c, key_mask=km, interpret=True)
        return jnp.sum(out * do), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tfa.shortseq_attention(tq, tk, tv, key_mask=None if km is None
                                 else torch.from_numpy(km))
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=0)

    def bh(x):
        return np.asarray(x).transpose(0, 2, 1, 3).reshape(B * H, S, D)

    _per_sequence_close([torch.from_numpy(bh(t.grad.numpy()))
                         for t in (tq, tk, tv)],
                        [bh(g) for g in jgrads], "float32")


def test_shortseq_function_backward_is_the_plain_backward():
    """`_ShortseqAttention`: its gradients are exactly the plain backward's
    from the saved O and LSE, one plain backward call, and the mask (data)
    gets no gradient even when it asks for one; under `torch.no_grad()`
    the forward alone runs."""
    S, D = 128, 64
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(5, S, D, n=4))
    km = torch.from_numpy(_key_mask(S, all_padding=False)).requires_grad_()
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    bwd = tfa.shortseq_attention_bwd.plain_calls
    out = tfa._ShortseqAttention.apply(tq, tk, tv, km, 0.125)
    out.backward(do)
    assert tfa.shortseq_attention_bwd.plain_calls == bwd + 1
    assert km.grad is None
    o, lse = tfa.shortseq_attention_plain(q, k, v, 0.125, km.detach())
    want = tfa.shortseq_attention_bwd_plain(q, k, v, o, do, lse, 0.125,
                                            km.detach())
    for w, t in zip(want, (tq, tk, tv)):
        torch.testing.assert_close(t.grad, w, rtol=0, atol=0)
    with torch.no_grad():
        again = tfa._ShortseqAttention.apply(tq, tk, tv, km, 0.125)
    assert again.grad_fn is None
    torch.testing.assert_close(again, out.detach(), rtol=0, atol=0)


def _bshd(seed, B_, S, H_, D, Skv=None):
    rng = np.random.RandomState(seed)
    q = rng.randn(B_, S, H_, D).astype(np.float32)
    k, v = (rng.randn(B_, Skv or S, H_, D).astype(np.float32)
            for _ in range(2))
    return q, k, v


def _counts():
    return (tfa.shortseq_attention_fwd.plain_calls,
            tfa.causal_attention_fwd.plain_calls,
            tfa.flash_attention.dense_calls)


def test_flash_attention_routes_like_jax():
    """Non-causal shortseq shapes take `shortseq_attention` (its plain
    version here); non-causal shapes JAX hands to the library kernel on a
    TPU (S 1024) take B6 (`sdpa_forward`, its plain version here) when no
    gradient is needed, as here, and are dense with one; every other
    non-causal shape (S 96, D 32) is dense on the CPU, as JAX computes it
    there; causal Sq == Skv takes the causal route. Each output matches
    JAX's `flash_attention`. Counts: (shortseq, causal, dense, B6)."""
    cases = [((1, 128, 2, 64), False, (1, 0, 0, 0)),
             ((1, 1024, 1, 64), False, (0, 0, 0, 1)),
             ((2, 96, 2, 64), False, (0, 0, 1, 0)),
             ((2, 128, 2, 32), False, (0, 0, 1, 0)),
             ((1, 128, 2, 64), True, (0, 1, 0, 0))]
    for i, ((b, S, h, D), causal, moved) in enumerate(cases):
        q, k, v = _bshd(20 + i, b, S, h, D)
        want = jfa.flash_attention(q, k, v, causal=causal)
        before = _counts() + (tfa.sdpa_forward.plain_calls,)
        got = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                  causal=causal)
        after = _counts() + (tfa.sdpa_forward.plain_calls,)
        assert tuple(a - b_ for a, b_ in zip(after, before)) == moved
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _bshd(21, 1, 1024, 1, 64))
    dense = tfa.flash_attention.dense_calls
    tfa.flash_attention(q, k, v, causal=False)
    assert tfa.flash_attention.dense_calls == dense + 1


def test_sdpa_key_mask_route_and_dense_route_match_jax():
    """`scaled_dot_product_attention` with the encoder's `[B, 1, 1, S]`
    additive mask (and a `[1, 1, 1, S]` one broadcast over the batch)
    takes the key-mask route, `shortseq_attention` with that mask; a full
    `[B, 1, S, S]` mask, `dropout_p > 0` outside training, or a mask on
    a shape no kernel takes take the dense branch, with no shortseq call.
    Each matches JAX's `scaled_dot_product_attention`."""
    S, D = 128, 64
    q, k, v = _bshd(30, B, S, H, D)
    km = _key_mask(S, all_padding=False)
    full = np.where(np.random.RandomState(3).rand(B, 1, S, S) < 0.2, -1e30,
                    0.0).astype(np.float32)
    full[..., 0] = 0.0                       # every row keeps a key
    q96, k96, v96 = _bshd(31, B, 96, H, D)
    cases = [
        ((q, k, v), km.reshape(B, 1, 1, S), 0.0, 1),
        ((q, k, v), km[:1].reshape(1, 1, 1, S), 0.0, 1),
        ((q, k, v), full, 0.0, 0),
        ((q, k, v), km.reshape(B, 1, 1, S), 0.1, 0),
        ((q96, k96, v96), np.zeros((B, 1, 1, 96), np.float32), 0.0, 0),
    ]
    for (a, b_, c), mask, p, routed in cases:
        want = j_sdpa(a, b_, c, attn_mask=mask, dropout_p=p, training=False)
        before = _counts()
        got = scaled_dot_product_attention(
            *(torch.from_numpy(x) for x in (a, b_, c)),
            attn_mask=torch.from_numpy(mask), dropout_p=p, training=False)
        assert tuple(x - y for x, y in zip(_counts(), before)) == (
            routed, 0, 0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want._array),
                                   atol=1e-5, rtol=0)
