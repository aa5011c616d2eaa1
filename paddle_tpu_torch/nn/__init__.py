"""Layers and helpers of the port outside the models: gradient clipping."""
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]
