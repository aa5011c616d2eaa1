"""The slice as a whole on the CPU: a GPT written as `nn` layers
(`tools/paddle_gpt_layers.py`) in both packages against the JAX package's
`GPTForCausalLM` (2 layers, hidden 64), from that model's `state_dict()`
through `set_state_dict`: the loss and every gradient; and the README's
"Drive it" flow (a `Sequential` MLP, `Adam`, ten eager steps), whose
losses match JAX's within 1e-5."""
import os
import sys

import jax
import numpy as np

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.models.gpt import GPTConfig, GPTForCausalLM

from _paddle_state import paddle_state  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import paddle_gpt_layers as pgl  # noqa: E402

V, H, L, NH, S, B = 97, 64, 2, 4, 16, 2


def _loss_and_grads(pkg, model, ids, labels):
    """The loss and {name: grad} of `model(ids, labels)`, numpy. JAX's
    side runs its eager tape under one `jax.jit` with the model's arrays
    as the arguments (one compile rather than one an op; the same
    values)."""
    def run():
        loss = model(pkg.to_tensor(ids), pkg.to_tensor(labels))
        loss.backward()
        return loss, {n: p.grad for n, p in model.named_parameters()
                      if p.grad is not None}

    if pkg is tp:
        loss, grads = run()
        return float(loss.numpy()), {n: g.numpy() for n, g in grads.items()}
    params = list(model.state_dict().values())
    saved = [t._array for t in params]

    def traced(arrays):
        for t, a in zip(params, arrays):
            t._array = a
        loss, grads = run()
        return loss._array, {n: g._array for n, g in grads.items()}

    try:
        loss, grads = jax.jit(traced)(saved)
    finally:
        for t, a in zip(params, saved):
            t._array = a
        model.clear_gradients()
    return float(loss), {n: np.asarray(g) for n, g in grads.items()}


def test_gpt_from_layers_matches_jax_gpt_for_causal_lm():
    jp.seed(3)
    ref = GPTForCausalLM(GPTConfig.tiny(vocab=V, hidden=H, layers=L,
                                        heads=NH, seq=S))
    state = {k: np.array(v.numpy(), np.float32)
             for k, v in ref.state_dict().items()}
    rng = np.random.RandomState(0)
    ids = rng.randint(0, V, (B, S)).astype(np.int64)
    labels = rng.randint(0, V, (B, S)).astype(np.int64)
    ref_loss, want = _loss_and_grads(jp, ref, ids, labels)
    for pkg in (jp, tp):
        pkg.seed(0)
        model = pgl.gpt_layers(pkg, V, H, L, NH, S)
        assert list(model.state_dict()) == list(state)
        missing, unexpected = model.set_state_dict(state)
        assert missing == [] and unexpected == []
        loss, got = _loss_and_grads(pkg, model, ids, labels)
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-6)
        assert set(got) == set(want)
        for k in want:
            scale = max(1.0, float(np.abs(want[k]).max()))
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=1e-5 * scale, err_msg=k)


def test_user_flow_losses_match_jax():
    want = pgl.user_flow(jp)
    got = pgl.user_flow(tp)
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
