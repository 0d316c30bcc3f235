"""Shared env-layer machinery: the batched state, goal sampling, reward.

Counterpart of `pybullet_multigoal_gym_tpu/envs/core.py`. Every tensor
carries a leading env axis; random draws come from a `torch.Generator` on
the env's device in place of per-env `jax.random` keys, so the JAX
``EnvState.key`` has no counterpart here.
"""

from typing import NamedTuple, Optional

import torch

from pybullet_multigoal_gym_tpu_torch.ops.dynamics import PhysicsState


class EnvState(NamedTuple):
    """Complete state of a batch of N environments (field order and names of
    the JAX `EnvState`, less ``key``)."""
    phys: PhysicsState
    steps: torch.Tensor              # (N,) int32 episode step counter
    ee_target: torch.Tensor          # (N, 3)
    ee_target_rot: torch.Tensor      # (N, 3) ZYZ euler accumulator
    joint_target: torch.Tensor       # (N, 7)
    desired_goal: torch.Tensor       # (N, GD)
    sub_goals: torch.Tensor          # (N, num_steps, GD)
    sub_goal_ind: torch.Tensor       # (N,) int32, -1 = none
    target_xyzs: torch.Tensor        # (N, NB, 3)
    block_order: torch.Tensor        # (N, NB) int32
    curriculum_level: torch.Tensor   # (N,) int32
    ind_block_to_move: torch.Tensor  # (N, NB) bool
    curriculum_prob: torch.Tensor    # (N, NC)
    goals_generated: torch.Tensor    # (N, NC)
    curriculum_update: torch.Tensor  # (N,) bool
    curriculum_goal_step: torch.Tensor  # (N,) int32
    door_hold_open: torch.Tensor     # (N,) bool
    spawn_body_pos: torch.Tensor     # (N, NB, 3)
    desired_goal_img: Optional[torch.Tensor] = None
    # host copy of ``steps``: episodes run in lockstep (``done`` comes only
    # from the TimeLimit), so the auto-reset branch is taken on the host
    # without reading the device
    host_steps: int = 0


def binary_or_dense_reward(achieved, desired, threshold, binary):
    """r = -(d > threshold) or -d, and whether the goal is achieved."""
    d = torch.linalg.vector_norm(achieved - desired, dim=-1)
    not_achieved = d > threshold
    reward = -not_achieved.to(achieved.dtype) if binary else -d
    return reward, ~not_achieved


def rejection_uniform(gen, lower, upper, valid_fn, n, n_trials: int = 24):
    """Fixed-trip masked rejection sampling for n envs at once: draws
    ``n_trials`` uniform candidates per env in [lower, upper) and returns
    the first one ``valid_fn`` accepts, or the last candidate if none is
    valid. ``valid_fn`` maps (n, n_trials, d) candidates to (n, n_trials)
    bools. Returns (n, d)."""
    device = gen.device
    lower = torch.as_tensor(lower, dtype=torch.float32, device=device)
    upper = torch.as_tensor(upper, dtype=torch.float32, device=device)
    u = torch.rand((n, n_trials) + tuple(lower.shape), generator=gen,
                   device=device)
    cands = lower + (upper - lower) * u
    valid = valid_fn(cands)
    idx = torch.where(valid.any(1), valid.float().argmax(1), n_trials - 1)
    return cands[torch.arange(n, device=device), idx]


def sample_block_positions(gen, n, n_block, lower_xy, upper_xy, avoid_xy, z,
                           min_dist: float = 0.06, n_trials: int = 24):
    """Place ``n_block`` objects one after another for n envs at once, each
    more than ``min_dist`` (xy) from the ones placed before it and from
    ``avoid_xy`` (the gripper start), by `rejection_uniform`. Returns (n,
    n_block, 3) positions at height ``z`` (JAX `core.py:89-111`)."""
    device = gen.device
    avoid = torch.as_tensor(avoid_xy, dtype=torch.float32, device=device)
    placed = []
    for _ in range(n_block):
        prev = torch.stack(placed, 1) if placed else None

        def valid(xy, prev=prev):                    # (n, T, 2) -> (n, T)
            ok = torch.linalg.vector_norm(xy - avoid, dim=-1) > min_dist
            if prev is not None:
                d = torch.linalg.vector_norm(xy[:, :, None] - prev[:, None],
                                             dim=-1)
                ok = ok & (d > min_dist).all(-1)
            return ok
        placed.append(rejection_uniform(gen, lower_xy, upper_xy, valid, n,
                                        n_trials))
    xy = torch.stack(placed, 1)
    return torch.cat([xy, xy.new_full((n, n_block, 1), z)], -1)
