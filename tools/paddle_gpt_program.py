"""A GPT written in the paddle API: the forward and loss of
paddle_tpu/models/gpt.py's `GPTForCausalLM(labels=)` as user code over
`nn.functional` and the Tensor methods, for either package.

`gpt_loss(paddle, params, input_ids, labels, num_heads)` takes the package
(`paddle_tpu` or `paddle_tpu_torch`) as an argument and the weights as
`params`, a dict of its tensors under the JAX GPT's `state_dict()` names
(Linear weights `[in, out]`, as `models/convert.py`'s `paddle_tpu_state`
gives them). The calls follow the JAX model's math:

- `F.embedding` of the tokens and of the positions, summed;
- a layer: `F.layer_norm`, `F.linear` to qkv `[in, 3H]`, the methods
  `reshape` and `transpose` to the heads, `F.scaled_dot_product_attention(
  is_causal=True)`, `F.linear` and a residual `+`; then `F.layer_norm`,
  `F.linear`, `F.gelu(approximate=True)`, `F.linear` and a residual `+`;
- the final `F.layer_norm`, the tied head `paddle.matmul(h, wte,
  transpose_y=True)` and `F.cross_entropy` over the flattened tokens.

`tests/test_torch_paddle_program.py` runs it in both packages on the CPU
(f32, and under `auto_cast` O1 bf16) and pins the JAX package's dispatch
counts (`FIXED_COUNTS`, `LAYER_COUNTS`); phase `paddle_program` of
`chip_smoke.py` runs it on the card at GPT-1.3B. Imports numpy only.
"""
import numpy as np

# JAX's OpStats.counts of one forward and loss: FIXED_COUNTS once, and
# LAYER_COUNTS once a layer; under auto_cast O1 the casts add
# AMP_CAST_FIXED + AMP_CAST_PER_LAYER * layers dispatches of `amp_cast`
FIXED_COUNTS = {"embedding": 2, "add": 1, "layer_norm": 1, "matmul": 1,
                "reshape": 2, "softmax_ce": 1, "squeeze_loss": 1,
                "reduce_loss": 1}
LAYER_COUNTS = {"layer_norm": 2, "linear": 4, "reshape": 2,
                "transpose": 1, "getitem": 3, "flash_attention": 1,
                "add": 2, "gelu": 1}
AMP_CAST_FIXED = 3
AMP_CAST_PER_LAYER = 10


def expected_counts(layers, o1=False):
    """The dispatch counts of a `layers`-deep program (zeros dropped)."""
    out = {}
    for k, v in FIXED_COUNTS.items():
        out[k] = out.get(k, 0) + v
    for k, v in LAYER_COUNTS.items():
        out[k] = out.get(k, 0) + v * layers
    if o1:
        out["amp_cast"] = AMP_CAST_FIXED + AMP_CAST_PER_LAYER * layers
    return {k: v for k, v in out.items() if v}


def random_state(vocab, hidden, layers, max_seq, ffn, seed=0):
    """numpy weights under the JAX GPT's names: N(0, 0.02) matrices,
    LayerNorm gains around 1, small biases."""
    rng = np.random.RandomState(seed)

    def mat(*shape):
        return (0.02 * rng.randn(*shape)).astype(np.float32)

    def vec(n, around=0.0):
        return (around + 0.1 * rng.randn(n)).astype(np.float32)

    st = {"gpt.wte.weight": mat(vocab, hidden),
          "gpt.wpe.weight": mat(max_seq, hidden),
          "gpt.ln_f.weight": vec(hidden, 1.0),
          "gpt.ln_f.bias": vec(hidden)}
    for i in range(layers):
        b = f"gpt.blocks.{i}."
        st.update({
            b + "ln1.weight": vec(hidden, 1.0), b + "ln1.bias": vec(hidden),
            b + "attn.qkv_proj.weight": mat(hidden, 3 * hidden),
            b + "attn.qkv_proj.bias": vec(3 * hidden),
            b + "attn.out_proj.weight": mat(hidden, hidden),
            b + "attn.out_proj.bias": vec(hidden),
            b + "ln2.weight": vec(hidden, 1.0), b + "ln2.bias": vec(hidden),
            b + "mlp.fc1.weight": mat(hidden, ffn),
            b + "mlp.fc1.bias": vec(ffn),
            b + "mlp.fc2.weight": mat(ffn, hidden),
            b + "mlp.fc2.bias": vec(hidden)})
    return st


def num_layers(params):
    return len({k.split(".")[2] for k in params
                if k.startswith("gpt.blocks.")})


def gpt_loss(paddle, params, input_ids, labels, num_heads, eps=1e-5):
    """The mean next-token cross entropy of the GPT `params` on
    `input_ids` `[B, S]` against `labels` `[B, S]`."""
    F = paddle.nn.functional
    B, S = input_ids.shape
    wte = params["gpt.wte.weight"]
    V, H = wte.shape
    D = H // num_heads
    pos = paddle.arange(S, dtype="int32")
    h = F.embedding(input_ids, wte) + F.embedding(pos,
                                                  params["gpt.wpe.weight"])
    for i in range(num_layers(params)):
        p = {k[len(f"gpt.blocks.{i}."):]: v for k, v in params.items()
             if k.startswith(f"gpt.blocks.{i}.")}
        x = F.layer_norm(h, H, p["ln1.weight"], p["ln1.bias"], eps)
        qkv = F.linear(x, p["attn.qkv_proj.weight"], p["attn.qkv_proj.bias"])
        qkv = qkv.reshape([B, S, 3, num_heads, D]).transpose([2, 0, 1, 3, 4])
        a = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2],
                                           is_causal=True)
        h = h + F.linear(a.reshape([B, S, H]), p["attn.out_proj.weight"],
                         p["attn.out_proj.bias"])
        x = F.layer_norm(h, H, p["ln2.weight"], p["ln2.bias"], eps)
        m = F.gelu(F.linear(x, p["mlp.fc1.weight"], p["mlp.fc1.bias"]),
                   approximate=True)
        h = h + F.linear(m, p["mlp.fc2.weight"], p["mlp.fc2.bias"])
    h = F.layer_norm(h, H, params["gpt.ln_f.weight"],
                     params["gpt.ln_f.bias"], eps)
    logits = paddle.matmul(h, wte, transpose_y=True)
    return F.cross_entropy(logits.reshape([-1, V]), labels.reshape([-1]))
