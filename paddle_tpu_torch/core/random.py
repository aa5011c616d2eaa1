"""RNG state: counterpart of paddle_tpu/core/random.py (phi::Generator,
paddle/phi/core/generator.h:23).

The JAX package's generator holds a jax PRNG key and splits a fresh
subkey per random op (jax 0.9.0's partitionable threefry). The port's
holds the same key as a pair of Python ints and splits it with the same
hash (`ops.threefry.split`), so a seed gives the JAX package's key chain,
and the random ops (`ops/random_ops.py`) draw jax's bits from each subkey
on the tensor's device. The global generator is the default on top of an
explicit `Generator`.
"""
from __future__ import annotations

import contextlib
import threading

from ..ops import threefry

__all__ = ["Generator", "default_generator", "seed", "next_key",
           "key_scope", "in_key_scope", "fold_key", "get_rng_state",
           "set_rng_state", "key_of_seed"]


def key_of_seed(seed: int):
    """jax.random.key(seed)'s data: (0, the seed's low 32 bits)."""
    return (0, int(seed) & threefry.M32)


class Generator:
    """Stateful wrapper over a threefry key chain (a pair of uint32 as
    Python ints)."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self.manual_seed(seed)

    def manual_seed(self, seed: int):
        with self._lock:
            self._seed = int(seed)
            self._key = key_of_seed(seed)
            self._count = 0
        return self

    def initial_seed(self) -> int:
        return self._seed

    def next_key(self):
        """Split and return a fresh subkey (thread-safe)."""
        with self._lock:
            self._key, sub = threefry.split(self._key)
            self._count += 1
            return sub

    def get_state(self):
        with self._lock:
            return (self._seed, self._count, self._key)

    def set_state(self, state):
        seed, count, key = state
        with self._lock:
            self._seed = int(seed)
            self._count = int(count)
            self._key = (int(key[0]), int(key[1]))


_default_generator = Generator(0)


def default_generator() -> Generator:
    return _default_generator


def seed(value: int) -> Generator:
    """Analog of paddle.seed: reseeds the global generator."""
    return _default_generator.manual_seed(value)


# A key scope: random ops inside derive their keys from `key` by folding
# in a counter, one fold a draw, instead of from the global generator (the
# JAX package's compiled steps take their per-step key so).
_key_scope_tls = threading.local()


@contextlib.contextmanager
def key_scope(key):
    prev = getattr(_key_scope_tls, "scope", None)
    _key_scope_tls.scope = [(int(key[0]), int(key[1])), 0]
    try:
        yield
    finally:
        _key_scope_tls.scope = prev


def in_key_scope() -> bool:
    return getattr(_key_scope_tls, "scope", None) is not None


def _fold(key, data):
    return threefry.threefry2x32(key[0], key[1], 0, int(data) & threefry.M32)


def next_key():
    """The next subkey: a fold of the scope's counter inside `key_scope`,
    else the global generator's split; then every active `fold_key`
    index folded in."""
    scope = getattr(_key_scope_tls, "scope", None)
    if scope is not None:
        k = _fold(scope[0], scope[1])
        scope[1] += 1
    else:
        k = _default_generator.next_key()
    for f in getattr(_key_scope_tls, "folds", ()):
        k = _fold(k, f)
    return k


@contextlib.contextmanager
def fold_key(idx):
    """Fold `idx` into every key drawn inside the context. Nestable; folds
    compose."""
    prev = tuple(getattr(_key_scope_tls, "folds", ()))
    _key_scope_tls.folds = prev + (int(idx),)
    try:
        yield
    finally:
        _key_scope_tls.folds = prev


def get_rng_state():
    return _default_generator.get_state()


def set_rng_state(state):
    _default_generator.set_state(state)
