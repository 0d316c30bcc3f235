"""Minimal gym-free space descriptions (Box / MultiDiscrete / Dict).

The reference builds `gym.spaces` objects (`robots/kuka.py:95-118`,
`envs/base_envs/base_env.py:86-110`); this framework avoids the gym
dependency but keeps the same structural information."""

import dataclasses
from typing import Dict as TDict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Box:
    low: Tuple
    high: Tuple
    shape: Tuple[int, ...]
    dtype: str = 'float32'

    @classmethod
    def unit(cls, n):
        return cls(low=tuple([-1.0] * n), high=tuple([1.0] * n), shape=(n,))

    @classmethod
    def unbounded(cls, shape):
        n = int(np.prod(shape))
        return cls(low=tuple([-np.inf] * n), high=tuple([np.inf] * n),
                   shape=tuple(shape))

    def contains(self, x):
        x = np.asarray(x)
        return (x.shape == self.shape and np.all(x >= np.asarray(self.low).reshape(self.shape) - 1e-6)
                and np.all(x <= np.asarray(self.high).reshape(self.shape) + 1e-6))

    def sample(self, rng=None):
        rng = rng or np.random
        lo = np.asarray(self.low, np.float32).reshape(self.shape)
        hi = np.asarray(self.high, np.float32).reshape(self.shape)
        lo = np.where(np.isfinite(lo), lo, -1.0)
        hi = np.where(np.isfinite(hi), hi, 1.0)
        return rng.uniform(lo, hi).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class MultiDiscrete:
    nvec: Tuple[int, ...]

    @property
    def shape(self):
        return (len(self.nvec),)

    def contains(self, x):
        x = np.asarray(x)
        return x.shape == self.shape and np.all(x >= 0) and np.all(x < self.nvec)

    def sample(self, rng=None):
        rng = rng or np.random
        draw = rng.integers if hasattr(rng, 'integers') else rng.randint
        return np.array([draw(0, n) for n in self.nvec])


@dataclasses.dataclass(frozen=True)
class Dict:
    spaces: TDict[str, object]

    def __getitem__(self, k):
        return self.spaces[k]

    def keys(self):
        return self.spaces.keys()
