"""Optimizers of the port: the base, SGD, Momentum, Adam, AdamW, Adagrad,
RMSProp, Adadelta, Lars and Lamb, and the LR schedulers (`optimizer.lr`)."""
from . import lr
from .optimizer import Optimizer
from .optimizers import (SGD, Adadelta, Adagrad, Adam, AdamW, Lamb, Lars,
                         Momentum, RMSProp)

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "RMSProp", "Adadelta", "Lars", "Lamb", "lr"]
