"""The port's optimizers against the JAX package's, on the CPU.

Same seeded numpy inputs to both packages. Each optimizer's update over
five steps (the port's `step()`, which runs the per-parameter loop of
`_single_update` on the CPU, against JAX's `_single_update`): parameters
and accumulators at f32 within 1e-6 relative (Lars' and Lamb's norms sum
in another order: within 2e-6), and bf16 parameters within one bf16 ulp
(2^-7 relative: the two may round a value on a half-ulp differently after
fp32 sums in another order). Adam and AdamW with `multi_precision=False`
keep bf16 moments, rounded every step, with beta rounded to bf16 as JAX's
weakly typed scalar rounds it: held to the same bars, and with the rounded
beta shown to matter. Then the surface knobs: `name=`, `lazy_mode`,
`lr_ratio`, `clear_grad(set_to_zero)`, `clear_gradients`, `minimize` and
`ClipGradByGlobalNorm(group_name=)`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt_mod
from paddle_tpu.nn import clip as jclip
import paddle_tpu_torch.optimizer as topt_mod
from paddle_tpu_torch import ClipGradByGlobalNorm

SHAPES = {"fc.weight": (6, 5), "fc.bias": (5,), "norm.weight": (7,)}
LR = 0.05

# case -> (optimizer class, constructor keyword arguments in both packages,
# which per-parameter JAX extras to pass); Lars excludes biases from decay
# by name in the port and through the per-parameter extras in JAX, whose
# parameters carry no names
CASES = {
    "sgd": ("SGD", {}, None),
    "sgd_l2": ("SGD", {"weight_decay": 0.01}, None),
    "adagrad": ("Adagrad", {"initial_accumulator_value": 0.1,
                            "weight_decay": 0.02}, None),
    "rmsprop": ("RMSProp", {"rho": 0.9}, None),
    "rmsprop_centered": ("RMSProp", {"rho": 0.9, "momentum": 0.9,
                                     "centered": True,
                                     "weight_decay": 0.01}, None),
    "adadelta": ("Adadelta", {"rho": 0.9, "epsilon": 1e-5}, None),
    "lars": ("Lars", {"momentum": 0.9, "lars_coeff": 0.01,
                      "lars_weight_decay": 0.05,
                      "exclude_from_weight_decay": ["bias"]}, "lars"),
    "lamb": ("Lamb", {"lamb_weight_decay": 0.01}, None),
    "adam_bf16_moments": ("Adam", {"multi_precision": False,
                                   "weight_decay": 0.01}, None),
    "adamw_bf16_moments": ("AdamW", {"multi_precision": False}, None),
}


def _inputs(dtype, seed):
    rng = np.random.RandomState(seed)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def rounded(a):
        return np.asarray(jnp.asarray(a, jdt).astype(jnp.float32))

    params = {n: rounded(0.3 * rng.randn(*s)) for n, s in SHAPES.items()}
    grads = [{n: rounded(rng.randn(*s) * (1 + k))
              for n, s in SHAPES.items()} for k in range(5)]
    return params, grads, jdt


def _extras(which, names, kwargs):
    if which != "lars":
        return {n: None for n in names}
    wd = kwargs["lars_weight_decay"]
    return {n: {"decay": jnp.asarray(0.0 if "bias" in n else wd,
                                     jnp.float32)} for n in names}


def _run(case, dtype, seed):
    """Five steps in both packages: (port parameters, port accumulators,
    JAX parameters, JAX accumulators), as fp32 numpy arrays by name, and
    the port's optimizer."""
    cls, kwargs, which = CASES[case]
    params, grads, jdt = _inputs(dtype, seed)
    names = list(params)
    jp = [paddle.to_tensor(params[n]).astype(jdt) for n in names]
    jopt = getattr(jopt_mod, cls)(learning_rate=LR, parameters=jp, **kwargs)
    jopt._ensure_state()
    jacc = {n: {k: v[i] for k, v in jopt._accumulators.items()}
            for i, n in enumerate(names)}
    jarr = {n: p._array for n, p in zip(names, jp)}
    extras = _extras(which, names, kwargs)
    tparams = {n: torch.nn.Parameter(torch.from_numpy(params[n]).to(dtype))
               for n in names}
    topt = getattr(topt_mod, cls)(learning_rate=LR, name=case,
                                  parameters=list(tparams.items()),
                                  **kwargs)
    for step, g in enumerate(grads):
        for n in names:
            jarr[n], jacc[n] = jopt._single_update(
                jarr[n], jnp.asarray(g[n], jdt), jacc[n],
                jnp.asarray(LR, jnp.float32), jnp.asarray(step, jnp.int32),
                extras=extras[n])
            tparams[n].grad = torch.from_numpy(g[n]).to(dtype)
        topt.step()
    assert topt._step_count == 5
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))  # noqa
    got_acc = {n: {k: v[i].float().numpy()
                   for k, v in topt._accumulators.items()}
               for i, n in enumerate(names)}
    return ({n: p.detach().float().numpy() for n, p in tparams.items()},
            got_acc, {n: f32(a) for n, a in jarr.items()},
            {n: {k: f32(a) for k, a in acc.items()}
             for n, acc in jacc.items()}, topt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_update_over_five_steps_matches_jax(case, dtype):
    got, got_acc, want, want_acc, topt = _run(case, dtype, seed=3)
    if dtype == torch.float32:
        rtol = 2e-6 if case in ("lars", "lamb") else 1e-6
        atol = 1e-7
    else:
        rtol, atol = 2 ** -7, 0
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=rtol, atol=atol,
                                   err_msg=f"{case} {n}")
        assert set(got_acc[n]) == set(want_acc[n]), case
        for k in want_acc[n]:
            np.testing.assert_allclose(
                got_acc[n][k], want_acc[n][k], rtol=max(rtol, 1e-6),
                atol=max(atol, 1e-9), err_msg=f"{case} {n} {k}")
    stored = {a.dtype for acc in topt._accumulators.values() for a in acc}
    if case.endswith("_bf16_moments"):
        assert stored == {dtype}
    elif stored:
        assert stored == {torch.float32}


def test_bf16_moments_round_beta_as_jax_does():
    """A bf16 moment times a Python beta: JAX's weakly typed scalar rounds
    beta to bf16 and the product to bf16, and the port's `_decayed` gives
    the same bits over 4096 values, where fp32 beta gives others for some
    (beta2 = 0.999 is 1.0 in bf16)."""
    from paddle_tpu_torch.optimizer.optimizers import _decayed

    m = torch.from_numpy(np.random.RandomState(2).randn(4096).astype(
        np.float32)).to(torch.bfloat16)
    jm = jnp.asarray(m.float().numpy(), jnp.bfloat16)
    for beta in (0.9, 0.999):
        want = np.asarray((beta * jm).astype(jnp.float32))
        got = _decayed(beta, m)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)
    assert float(torch.tensor(0.999, dtype=torch.bfloat16)) == 1.0
    fp32_beta = (0.9 * m.float()).to(torch.bfloat16)
    assert not torch.equal(fp32_beta, _decayed(0.9, m))


def test_lamb_ignores_its_exclusion_fn_and_lars_excludes_by_name():
    """JAX's Lamb accepts exclude_from_weight_decay_fn and never calls it;
    the port's Lars takes its decays from the parameter names."""
    p = torch.nn.Parameter(torch.ones(3))
    called = []
    lamb = topt_mod.Lamb(0.1, parameters=[("fc.bias", p)],
                         exclude_from_weight_decay_fn=called.append)
    p.grad = torch.full((3,), 0.5)
    lamb.step()
    assert called == []
    lars = topt_mod.Lars(0.1, parameters=[("fc.bias", p), ("bn.weight", p),
                                          ("fc.weight", p)],
                         exclude_from_weight_decay=["bias", "bn"])
    assert lars._decay == [0.0, 0.0, 0.0005]


def test_surface_knobs_match_jax():
    """name=, lazy_mode and lr_ratio are accepted and change nothing;
    clear_grad(set_to_zero=True) drops the grads as JAX's does;
    clear_gradients is clear_grad; minimize is backward, step and
    clear_grad, returning (None, None), one step equal to JAX's within
    1e-6; ClipGradByGlobalNorm keeps group_name and clips as without it."""
    rng = np.random.RandomState(5)
    w = rng.randn(4, 3).astype(np.float32)
    x = rng.randn(2, 4).astype(np.float32)
    jw = paddle.to_tensor(w)
    jw.stop_gradient = False
    jo = jopt_mod.AdamW(0.1, parameters=[jw], lr_ratio=0.5, name="j",
                        multi_precision=True)
    tw = torch.nn.Parameter(torch.from_numpy(w.copy()))
    to = topt_mod.AdamW(0.1, parameters=[tw], lr_ratio=0.5, name="t")
    jloss = (paddle.to_tensor(x).matmul(jw) ** 2).sum()
    assert jo.minimize(jloss) == (None, None)
    tloss = (torch.from_numpy(x) @ tw).square().sum()
    assert to.minimize(tloss) == (None, None)
    assert tw.grad is None and to._step_count == 1
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw._array),
                               rtol=1e-6, atol=1e-7)
    lazy = []
    for kw in ({"lazy_mode": True, "name": "a"}, {}):
        q = torch.nn.Parameter(torch.ones(3))
        q.grad = torch.full((3,), 0.5)
        topt_mod.Adam(0.1, parameters=[q], **kw).step()
        lazy.append(q.detach())
    assert torch.equal(*lazy)
    tw.grad = torch.ones_like(tw)
    to.clear_grad(set_to_zero=True)
    assert tw.grad is None
    tw.grad = torch.ones_like(tw)
    to.clear_gradients()
    assert tw.grad is None
    assert topt_mod.Optimizer.clear_gradients is topt_mod.Optimizer.clear_grad
    clip = ClipGradByGlobalNorm(0.5, group_name="g")
    assert clip.group_name == "g"
    assert ClipGradByGlobalNorm(0.5).group_name == \
        jclip.ClipGradByGlobalNorm(0.5).group_name == "default_group"
    grads = [torch.from_numpy(rng.randn(3, 2).astype(np.float32)), None]
    pairs = [(torch.zeros(1), g) for g in grads]
    a = clip(pairs)
    b = ClipGradByGlobalNorm(0.5)(pairs)
    assert torch.equal(a[0][1], b[0][1]) and a[1][1] is None
    want = jclip.ClipGradByGlobalNorm(0.5, group_name="g")._clip_arrays(
        [jnp.asarray(grads[0].numpy()), None])
    np.testing.assert_allclose(a[0][1].numpy(), np.asarray(want[0]),
                               rtol=1e-6)


@pytest.mark.parametrize("cls", ["SGD", "Momentum", "Adam", "AdamW",
                                 "Adagrad", "RMSProp", "Adadelta", "Lars",
                                 "Lamb"])
def test_every_optimizer_takes_name_and_is_exported(cls):
    import paddle_tpu_torch

    p = torch.nn.Parameter(torch.ones(2))
    opt = getattr(paddle_tpu_torch, cls)(learning_rate=0.1, parameters=[p],
                                         name="mine")
    assert getattr(topt_mod, cls) is getattr(paddle_tpu_torch, cls)
    p.grad = torch.full((2,), 0.25)
    opt.step()
    assert opt._step_count == 1
    state = opt.state_dict()
    twin = getattr(paddle_tpu_torch, cls)(learning_rate=0.1,
                                          parameters=[p])
    twin.set_state_dict(state)
    for k, lst in opt._accumulators.items():
        assert torch.equal(twin._accumulators[k][0], lst[0]), k
