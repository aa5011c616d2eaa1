"""Optimizers of the port: the base, Momentum, Adam and AdamW, and the LR schedulers
(`optimizer.lr`)."""
from . import lr
from .optimizer import Optimizer
from .optimizers import Adam, AdamW, Momentum

__all__ = ["Optimizer", "Momentum", "Adam", "AdamW", "lr"]
