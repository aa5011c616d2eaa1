"""Distributed serving of the port (counterpart of the serving part of
paddle_tpu/distributed): the tensor-parallel serving mesh."""
from .topology import ServingMesh, serving_mesh

__all__ = ["ServingMesh", "serving_mesh"]
