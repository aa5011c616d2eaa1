"""The serving mesh: counterpart of `serving_mesh` in
paddle_tpu/distributed/topology.py.

Tensor-parallel serving keeps ONE host-side scheduler, as the JAX engine
does (DESIGN_DECISIONS r12): the engine drives every shard's work from one
process, and a mesh is the list of torch devices its shards live on, one a
shard, in mesh order (the order of the heads and columns each shard owns).
On a host with mp cards it names `cuda:0 .. cuda:mp-1`. A list may name
one device several times: a virtual mesh, whose shards run one after the
other on that device with the same per-shard shapes, kernels and gathers
as on mp cards. The JAX package's CPU tests run its mp=2 and mp=4 programs
the same way, on host devices that XLA is told to fake
(`--xla_force_host_platform_device_count=8`, tests/conftest.py).
"""
from __future__ import annotations

import torch

__all__ = ["ServingMesh", "serving_mesh", "check_mp_axis"]


def _normalize(device):
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_mp_axis(mp_axis):
    """Refuse a mesh axis name other than `'mp'`: the JAX package's pools
    take the name of the axis their heads shard over, and a serving mesh
    here has that one axis only."""
    if mp_axis != "mp":
        raise ValueError(
            f"mp_axis={mp_axis!r}: a serving mesh has the one axis 'mp'")


class ServingMesh:
    """A one-axis `('mp',)` mesh of torch devices: `devices` (a tuple, one
    a shard, in mesh order), `shape == {"mp": len(devices)}`,
    `axis_names == ("mp",)`. `distinct` lists each device once, in the
    order of its first shard."""

    axis_names = ("mp",)

    def __init__(self, devices):
        self.devices = tuple(_normalize(d) for d in devices)
        if not self.devices:
            raise ValueError("a serving mesh needs at least one device")
        self.shape = {"mp": len(self.devices)}
        self.distinct = tuple(dict.fromkeys(self.devices))

    def __eq__(self, other):
        return isinstance(other, ServingMesh) and \
            self.devices == other.devices

    def __repr__(self):
        return f"ServingMesh(devices={[str(d) for d in self.devices]})"


def serving_mesh(mp, *, num_heads=None, vocab_size=None, devices=None):
    """One-axis `('mp',)` mesh for tensor-parallel SERVING.

    Validates the shapes the Megatron-style inference sharding needs UP
    FRONT, with the JAX package's messages (attention sharded by heads,
    the embedding and the tied head by vocab rows), so a bad degree fails
    here instead of deep inside a per-shard reshape.

    `devices` lists the shards' devices (the first mp are taken); it may
    repeat one device (a virtual mesh: `devices=["cpu"] * mp` on the
    CPU). Without it the mesh takes the host's cards `cuda:0 ..
    cuda:mp-1` and raises when there are fewer."""
    mp = int(mp)
    if mp < 1:
        raise ValueError(f"mp degree must be >= 1, got {mp}")
    if num_heads is not None and num_heads % mp != 0:
        raise ValueError(
            f"num_heads={num_heads} is not divisible by mp degree "
            f"{mp} — head-sharded attention needs num_heads % mp == 0")
    if vocab_size is not None and vocab_size % mp != 0:
        raise ValueError(
            f"vocab_size={vocab_size} is not divisible by mp degree "
            f"{mp} — the vocab-parallel embedding/lm_head needs "
            "vocab % mp == 0")
    if devices is not None:
        devices = list(devices)
    else:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [f"cuda:{i}" for i in range(n)]
    if mp > len(devices):
        raise ValueError(
            f"serving mesh needs {mp} devices, have {len(devices)}")
    return ServingMesh(devices[:mp])
