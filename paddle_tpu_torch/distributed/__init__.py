"""Distributed serving of the port (counterpart of the serving part of
paddle_tpu/distributed): the tensor-parallel serving mesh."""
from .topology import ServingMesh, check_mp_axis, serving_mesh

__all__ = ["ServingMesh", "serving_mesh", "check_mp_axis"]
