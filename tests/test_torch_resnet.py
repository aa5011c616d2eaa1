"""ResNet eval inference of the PyTorch port against the JAX package, on the
CPU.

One JAX model of each depth (resnet50 and resnet18, 10 classes, f32,
`conv_backend="dense"`, which is what JAX's `auto` runs on the CPU) is
built per module, its BatchNorm weights, biases, running means and
(positive) variances drawn from a seed (at init they are the identity,
which would hide a wrong fold), and its logits computed at batch 2,
32 x 32, before and after JAX's `fuse_conv_bn`. The port's model takes the
same entries through the weight bridge:
- the bridge round-trips all 267 entries of resnet50 (106 of them
  BatchNorm buffers), and a missing, extra or misshapen entry raises;
- the logits on the kernel route (`auto`: the kernels' plain versions on
  the CPU, 36 1x1 and 16 3x3 calls a resnet50 forward, none for the stem)
  and on the dense route agree with JAX's;
- `fuse_conv_bn` folds as many BatchNorms as JAX's, to the same weights
  and biases, and the folded logits agree;
- `.to(torch.bfloat16)` casts the BatchNorm buffers, as JAX's `Layer.to`;
- a port model built on its own draws the JAX init scheme.

Tolerance: logits within 1e-5 of max |JAX logit| (fp32 convolutions that
sum in another order; the port read 1.6e-6 on resnet50).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn.fused import fuse_conv_bn as j_fuse_conv_bn
from paddle_tpu.vision.models import resnet18 as j_resnet18
from paddle_tpu.vision.models import resnet50 as j_resnet50
from paddle_tpu_torch import (load_paddle_tpu_state, paddle_tpu_state,
                              resnet18, resnet50)
from paddle_tpu_torch.nn import BatchNorm2D, ConvBNReLU, fuse_conv_bn
from paddle_tpu_torch.ops import conv as tconv

LOGIT_TOL = 1e-5
# bench.py's budget for the fused bf16 route against the dense one
BF16_REL_TOL = 0.03
MODELS = {"resnet50": (j_resnet50, resnet50, (36, 16), 53),
          "resnet18": (j_resnet18, resnet18, (3, 16), 20)}


def _seed_stats(arrays, rng):
    """The JAX state with every BatchNorm's gamma, beta, running mean and
    running variance drawn from `rng`."""
    draws = {"._mean": (-0.5, 0.5), "._variance": (0.5, 2.0),
             "bn.weight": (0.5, 1.5), "bn1.weight": (0.5, 1.5),
             "bn.bias": (-0.5, 0.5), "bn1.bias": (-0.5, 0.5)}
    out = {}
    for name, a in arrays.items():
        for suffix, (lo, hi) in draws.items():
            if name.endswith(suffix):
                a = rng.uniform(lo, hi, a.shape)
                break
        out[name] = np.asarray(a, np.float32)
    return out


def _jax_case(name, seed):
    builder = MODELS[name][0]
    paddle.seed(seed)
    jm = builder(num_classes=10, conv_backend="dense")
    jm.eval()
    init = {k: np.asarray(v._array) for k, v in jm.state_dict().items()}
    arrays = _seed_stats(init, np.random.RandomState(seed + 1))
    assert jm.set_state_dict(arrays) == ([], [])
    x = np.random.RandomState(seed + 2).uniform(
        -1, 1, (2, 3, 32, 32)).astype(np.float32)
    logits = jm(paddle.to_tensor(x)).numpy()
    n_folded = j_fuse_conv_bn(jm)
    folded = {k: np.asarray(v._array) for k, v in jm.state_dict().items()}
    return dict(init=init, arrays=arrays, x=x, logits=logits,
                n_folded=n_folded, folded=folded,
                folded_logits=jm(paddle.to_tensor(x)).numpy())


@pytest.fixture(scope="module")
def cases():
    """Both JAX models and their outputs, built once for the module."""
    return {"resnet50": _jax_case("resnet50", 0),
            "resnet18": _jax_case("resnet18", 1)}


def _port(name, case, **kw):
    tm = MODELS[name][1](num_classes=10, device="cpu", **kw)
    load_paddle_tpu_state(tm, case["arrays"])
    return tm.eval()


def _rel_err(got, ref):
    return float(np.max(np.abs(np.asarray(got, np.float32) - ref))
                 / np.max(np.abs(ref)))


def _counts():
    return (tconv.conv1x1_bn_relu.plain_calls,
            tconv.conv3x3_bn_relu.plain_calls,
            tconv.conv1x1_bn_relu.launches, tconv.conv3x3_bn_relu.launches,
            tconv.fused_conv_bn_relu.dense_calls)


def _forward(tm, x):
    """Logits and the counts the forward added: (1x1 plain, 3x3 plain, 1x1
    launches, 3x3 launches, dense calls)."""
    before = _counts()
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    return out, tuple(b - a for a, b in zip(before, _counts()))


def test_weight_bridge_round_trips_every_entry(cases):
    """267 entries of resnet50's JAX state_dict, the 106 BatchNorm buffers
    among them, go into the port and come back unchanged; conv weights
    stay OIHW and `fc` transposes."""
    case = cases["resnet50"]
    arrays = case["arrays"]
    assert len(arrays) == 267
    assert sum(k.endswith(("._mean", "._variance")) for k in arrays) == 106
    tm = _port("resnet50", case)
    assert len(dict(tm.named_buffers())) == 106
    back = paddle_tpu_state(tm)
    assert set(back) == set(arrays)
    for name, a in arrays.items():
        np.testing.assert_array_equal(back[name], a, err_msg=name)
    assert tuple(tm.fc.weight.shape) == arrays["fc.weight"].shape[::-1]
    assert tuple(tm.conv1.weight.shape) == arrays["conv1.weight"].shape
    missing = dict(arrays)
    missing.pop("layer3.2.convbn2.bn._variance")
    with pytest.raises(KeyError, match="missing"):
        load_paddle_tpu_state(tm, missing)
    with pytest.raises(KeyError, match="unused"):
        load_paddle_tpu_state(tm, dict(arrays, **{
            "layer1.0.convbn1.conv.bias": np.zeros(64, np.float32)}))
    with pytest.raises(ValueError, match="shape"):
        load_paddle_tpu_state(tm, dict(arrays, **{
            "bn1._mean": np.zeros(63, np.float32)}))


@pytest.mark.parametrize("name", list(MODELS))
def test_logits_match_jax_on_both_routes(cases, name):
    """The kernel route (plain versions on the CPU: resnet50 36 1x1 and 16
    3x3 calls, resnet18 3 and 16; no launch; the stem and nothing else
    outside them) and the dense route (every block conv composed) give
    JAX's logits."""
    case = cases[name]
    n1, n3 = MODELS[name][2]
    got, counts = _forward(_port(name, case), case["x"])
    assert counts == (n1, n3, 0, 0, 0)
    assert _rel_err(got.numpy(), case["logits"]) <= LOGIT_TOL
    got, counts = _forward(_port(name, case, conv_backend="dense"),
                           case["x"])
    assert counts == (0, 0, 0, 0, n1 + n3)
    assert _rel_err(got.numpy(), case["logits"]) <= LOGIT_TOL


@pytest.mark.parametrize("name", list(MODELS))
def test_fuse_conv_bn_matches_jax(cases, name):
    """`fuse_conv_bn` folds every block and the stem's conv1/bn1 pair, as
    JAX's does, to the same weights and biases (both in fp64 on the host,
    one cast), and the folded model gives JAX's folded logits through the
    composition route."""
    case = cases[name]
    tm = _port(name, case)
    assert fuse_conv_bn(tm) == case["n_folded"] == MODELS[name][3]
    assert isinstance(tm.bn1, torch.nn.Identity)
    assert all(m._folded for m in tm.modules() if isinstance(m, ConvBNReLU))
    assert fuse_conv_bn(tm) == 0
    state = paddle_tpu_state(tm)
    assert set(state) == set(case["folded"])
    for key, a in case["folded"].items():
        np.testing.assert_allclose(state[key], a, rtol=1e-7, atol=0,
                                   err_msg=key)
    got, counts = _forward(tm, case["x"])
    assert counts[:4] == (0, 0, 0, 0)
    assert _rel_err(got.numpy(), case["folded_logits"]) <= LOGIT_TOL
    assert _rel_err(got.numpy(), case["logits"]) <= LOGIT_TOL


def test_bf16_casts_batchnorm_buffers(cases):
    """`.to(torch.bfloat16)` casts `_mean` and `_variance` with the
    parameters (JAX's `Layer.to` casts buffers too), and the bf16 model's
    logits stay within bench.py's fused-route budget of the f32 ones."""
    case = cases["resnet50"]
    tm = _port("resnet50", case).to(torch.bfloat16)
    bns = [m for m in tm.modules() if isinstance(m, BatchNorm2D)]
    assert len(bns) == 53
    assert all(b._mean.dtype == b._variance.dtype == torch.bfloat16
               for b in bns)
    with torch.no_grad():
        got = tm(torch.from_numpy(case["x"]).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert _rel_err(got.float().numpy(), case["logits"]) <= BF16_REL_TOL


def test_resnet_draws_the_jax_init_scheme(cases):
    """Built on its own, the port draws JAX's scheme: KaimingUniform conv
    weights and a Xavier-normal fc (each tensor's spread within 5 % of the
    JAX model's), zero fc bias, BatchNorm at the identity."""
    init = cases["resnet50"]["init"]
    tm = resnet50(num_classes=10, device="cpu")
    state = paddle_tpu_state(tm)
    assert set(state) == set(init)
    for name, a in init.items():
        got = state[name]
        if name.endswith("weight") and a.ndim > 1:
            assert abs(got.std() / a.std() - 1) < 0.05, name
        else:
            np.testing.assert_array_equal(got, a, err_msg=name)


def test_resnet_layouts_heads_and_modes(cases):
    """NCHW and channels_last inputs give the same logits; without a head
    or a pool the features come back; training mode normalizes by batch
    statistics (other logits than eval) and updates the running statistics
    (tests/test_torch_resnet_train.py holds it against JAX)."""
    case = cases["resnet18"]
    tm = _port("resnet18", case)
    x = torch.from_numpy(case["x"])
    with torch.no_grad():
        a = tm(x)
        b = tm(x.contiguous(memory_format=torch.channels_last))
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        feats = resnet18(num_classes=0, with_pool=False,
                         device="cpu").eval()(x)
    assert feats.shape == (2, 512, 1, 1)
    before = tm.bn1._mean.clone()
    tm.train()
    with torch.no_grad():
        c = tm(x)
    assert c.shape == a.shape and bool(torch.isfinite(c).all())
    assert not torch.equal(c, a)
    assert not torch.equal(tm.bn1._mean, before)
