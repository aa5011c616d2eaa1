"""A GPT written as `nn` layers: paddle_tpu/models/gpt.py's
`GPTForCausalLM(labels=)` as user code over `nn.Layer`, for either
package.

`gpt_layers(paddle, vocab, hidden, layers, heads, max_seq, ffn)` takes
the package (`paddle_tpu` or `paddle_tpu_torch`) as an argument and builds
the model on the selected place from

- `nn.Embedding` x2 (tokens and positions),
- an `nn.LayerList` of blocks, each with `nn.LayerNorm` x2, `nn.Linear`
  x4 (`attn.qkv_proj`, `attn.out_proj`, `mlp.fc1`, `mlp.fc2`, weights
  `[in, out]`) and `nn.Dropout(0.0)`, attention through
  `F.scaled_dot_product_attention(is_causal=True)` and `F.gelu(
  approximate=True)`,
- the final `nn.LayerNorm` and the head tied to the token embedding
  (`paddle.matmul(h, wte, transpose_y=True)`), then `F.cross_entropy`.

Its `state_dict()` names are the JAX GPT's (`gpt.wte.weight`,
`gpt.blocks.{i}.attn.qkv_proj.weight`, ...), so `set_state_dict` takes
that model's state (`models/convert.py`'s `paddle_tpu_state` gives it
from the port's module). `tests/test_torch_paddle_layers.py` runs it in
both packages on the CPU against JAX's `GPTForCausalLM`; phase
`paddle_layers` of `chip_smoke.py` runs it on the card at GPT-1.3B.
Imports numpy only.
"""
import numpy as np


def gpt_layers(paddle, vocab, hidden, layers, heads, max_seq, ffn=None,
               eps=1e-5):
    """The GPT as an `nn.Layer` of `paddle`; `model(ids, labels)` gives
    the mean next-token cross entropy, `model(ids)` the logits."""
    nn, F = paddle.nn, paddle.nn.functional
    ffn = ffn or 4 * hidden
    D = hidden // heads

    class Attention(nn.Layer):
        def __init__(self):
            super().__init__()
            self.qkv_proj = nn.Linear(hidden, 3 * hidden)
            self.out_proj = nn.Linear(hidden, hidden)

        def forward(self, x):
            B, S = x.shape[0], x.shape[1]
            qkv = self.qkv_proj(x).reshape([B, S, 3, heads, D]) \
                .transpose([2, 0, 1, 3, 4])
            a = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2],
                                               is_causal=True)
            return self.out_proj(a.reshape([B, S, hidden]))

    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(hidden, ffn)
            self.fc2 = nn.Linear(ffn, hidden)

        def forward(self, x):
            return self.fc2(F.gelu(self.fc1(x), approximate=True))

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.ln1 = nn.LayerNorm(hidden, epsilon=eps)
            self.attn = Attention()
            self.ln2 = nn.LayerNorm(hidden, epsilon=eps)
            self.mlp = MLP()
            self.drop = nn.Dropout(0.0)

        def forward(self, h):
            h = h + self.drop(self.attn(self.ln1(h)))
            return h + self.drop(self.mlp(self.ln2(h)))

    class Body(nn.Layer):
        def __init__(self):
            super().__init__()
            self.wte = nn.Embedding(vocab, hidden)
            self.wpe = nn.Embedding(max_seq, hidden)
            self.blocks = nn.LayerList([Block() for _ in range(layers)])
            self.ln_f = nn.LayerNorm(hidden, epsilon=eps)

        def forward(self, input_ids):
            S = input_ids.shape[1]
            pos = paddle.arange(S, dtype="int32")
            h = self.wte(input_ids) + self.wpe(pos)
            for block in self.blocks:
                h = block(h)
            return self.ln_f(h)

    class GPTLayers(nn.Layer):
        def __init__(self):
            super().__init__()
            self.gpt = Body()

        def forward(self, input_ids, labels=None):
            h = self.gpt(input_ids)
            logits = paddle.matmul(h, self.gpt.wte.weight, transpose_y=True)
            if labels is None:
                return logits
            return F.cross_entropy(logits.reshape([-1, vocab]),
                                   labels.reshape([-1]))

    return GPTLayers()


# the README's "Drive it" flow: a Sequential MLP trained with Adam, ten
# eager steps
def user_flow(paddle, steps=10, seed=0):
    """The losses of the flow's steps (floats); the inputs are numpy draws
    of `seed`, the weights the package's seeded init."""
    nn, F = paddle.nn, paddle.nn.functional
    paddle.seed(seed)
    net = nn.Sequential(nn.Linear(8, 16), nn.Tanh(), nn.Linear(16, 1))
    opt = paddle.optimizer.Adam(learning_rate=1e-2,
                                parameters=net.parameters())
    rng = np.random.RandomState(seed)
    x = paddle.to_tensor(rng.randn(16, 8).astype(np.float32))
    y = paddle.to_tensor(rng.randn(16, 1).astype(np.float32))
    losses = []
    for _ in range(steps):
        loss = F.mse_loss(net(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    return losses
