"""Optimizers of the port: the base, Adam and AdamW, and the LR schedulers
(`optimizer.lr`)."""
from . import lr
from .optimizer import Optimizer
from .optimizers import Adam, AdamW

__all__ = ["Optimizer", "Adam", "AdamW", "lr"]
