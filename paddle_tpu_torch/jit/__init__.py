"""Training step of the port: `TrainStep`."""
from .api import TrainStep

__all__ = ["TrainStep"]
