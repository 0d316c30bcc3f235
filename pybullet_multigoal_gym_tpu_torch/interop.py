"""Convert the port's env state to and from numpy leaves keyed by path.

The keys are those of the JAX package's checkpoints
(`pybullet_multigoal_gym_tpu/utils/checkpoint.py`): ``.phys.q``,
``.phys.body_pos``, ``.steps``, ``.desired_goal``, ... A state saved by the
JAX package therefore loads here (``np.load`` of its ``.npz``), and the same
state can be fed to both packages. The JAX per-env PRNG ``.key`` has no
counterpart (the port draws from a `torch.Generator`) and is ignored; goal
images are not carried.
"""

from typing import Dict, Mapping

import numpy as np
import torch

from pybullet_multigoal_gym_tpu_torch.envs.core import EnvState
from pybullet_multigoal_gym_tpu_torch.ops.dynamics import PhysicsState
from pybullet_multigoal_gym_tpu_torch.utils.tensors import resolve_device

_SKIP = ('phys', 'desired_goal_img', 'host_steps')
ENV_FIELDS = tuple(f for f in EnvState._fields if f not in _SKIP)


def _keys():
    return (['.phys.' + f for f in PhysicsState._fields]
            + ['.' + f for f in ENV_FIELDS])


def state_from_numpy(leaves: Mapping[str, np.ndarray], device=None) -> EnvState:
    """An `EnvState` on ``device`` (default CUDA) from path-keyed leaves.
    Raises if a leaf is missing or the episodes are not in lockstep."""
    device = resolve_device(device)
    missing = [k for k in _keys() if k not in leaves]
    if missing:
        raise KeyError('state leaves missing: %s' % missing)

    def t(key):
        return torch.as_tensor(np.asarray(leaves[key]), device=device)

    steps = np.asarray(leaves['.steps'])
    if steps.size and (steps != steps.flat[0]).any():
        raise ValueError('episodes must be in lockstep (done comes only from '
                         'the TimeLimit); got steps %s' % np.unique(steps))
    phys = PhysicsState(*[t('.phys.' + f) for f in PhysicsState._fields])
    return EnvState(phys=phys, **{f: t('.' + f) for f in ENV_FIELDS},
                    host_steps=int(steps.flat[0]) if steps.size else 0)


def state_to_numpy(state: EnvState) -> Dict[str, np.ndarray]:
    """Path-keyed numpy leaves of ``state`` (the inverse of
    :func:`state_from_numpy`)."""
    out = {'.phys.' + f: v.detach().cpu().numpy()
           for f, v in zip(PhysicsState._fields, state.phys)}
    for f in ENV_FIELDS:
        out['.' + f] = getattr(state, f).detach().cpu().numpy()
    return out
