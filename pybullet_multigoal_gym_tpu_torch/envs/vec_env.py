"""Vectorised environment front-end: one batch of environments on one
device, with TimeLimit and auto-reset.

Counterpart of `pybullet_multigoal_gym_tpu/envs/vec_env.py`. A step runs
decode -> IK (kernel K1) -> control step (kernel K2 for the single-step
family, K3 for the multi-step and insertion families) -> observation and
reward -> TimeLimit; in the push-primitive family one step is a whole
primitive, 20 pairs of K1 and K3 launches (`envs/shape_assemble.py`).
``done`` comes only from the TimeLimit, as in the reference, where
``env.step`` always returns ``done=False`` and gym's ``TimeLimit`` wrapper
truncates, so all episodes of a batch run in lockstep: the reset branch is
decided from the state's host step count and never waits for the device.
"""

import torch

from pybullet_multigoal_gym_tpu_torch.config import EnvConfig, env_id
from pybullet_multigoal_gym_tpu_torch.envs.insertion import KukaInsertionEnv
from pybullet_multigoal_gym_tpu_torch.envs.multi_step import KukaMultiBlockEnv
from pybullet_multigoal_gym_tpu_torch.envs.shape_assemble import (
    KukaPrimitiveEnv)
from pybullet_multigoal_gym_tpu_torch.envs.single_step import KukaSingleStepEnv
from pybullet_multigoal_gym_tpu_torch.ops import dynamics as D
from pybullet_multigoal_gym_tpu_torch.utils import spaces
from pybullet_multigoal_gym_tpu_torch.utils.tensors import resolve_device


def _make_core(cfg: EnvConfig, device):
    """The family's batched env (JAX `vec_env.py:27-39`)."""
    if cfg.family == 'single_step':
        return KukaSingleStepEnv(cfg, device)
    if cfg.family == 'multi_step':
        return KukaMultiBlockEnv(cfg, device)
    if cfg.family == 'shape_assemble':
        return KukaPrimitiveEnv(cfg, device)
    return KukaInsertionEnv(cfg, device)


class VecMGEnv:
    """Batched multigoal env on one device.

    Usage::

        env = VecMGEnv(EnvConfig(task='push'), num_envs=4096)
        state, obs = env.reset()
        state, obs, reward, done, info = env.step(state, actions)

    ``device=None`` means CUDA, and raises where CUDA is missing; pass
    ``device='cpu'`` to run the plain PyTorch versions of the kernels.
    Random draws (resets, the state noise) come from ``self.generator``,
    seeded by ``seed``.
    """

    def __init__(self, cfg: EnvConfig, num_envs: int = 1, device=None,
                 seed: int = 0, auto_reset: bool = True):
        cfg.validate()
        if not isinstance(num_envs, int) or num_envs < 1:
            raise ValueError('num_envs must be a positive int, got %r'
                             % (num_envs,))
        self.cfg = cfg
        self.num_envs = num_envs
        self.auto_reset = auto_reset
        self.device = resolve_device(device)
        self.core = _make_core(cfg, self.device)
        self.env_id = env_id(cfg)
        self.max_episode_steps = cfg.max_episode_steps
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def reset(self, seed=None):
        """New episodes for the whole batch: (state, obs)."""
        if seed is not None:
            self.generator.manual_seed(seed)
        return self.core.reset(self.num_envs, self.generator)

    def _auto_reset(self, state):
        """Fresh episodes after the TimeLimit; the multi-step family keeps
        its curriculum bookkeeping across them (JAX `vec_env.py:219-229`)."""
        n = state.phys.q.shape[0]
        if self.cfg.family == 'multi_step':
            return self.core.reset(n, self.generator, curr=(
                state.curriculum_prob, state.goals_generated,
                state.curriculum_update))
        return self.core.reset(n, self.generator)

    def step(self, state, action):
        """One action per env, (N, action_dim): returns (state, obs, reward,
        done, info). Where the TimeLimit ends the episodes, the returned obs,
        reward and info are those of the last step and the returned state
        is a fresh reset."""
        core = self.core
        if self.cfg.primitive is not None:
            # JAX `vec_env.py:175-181`
            phys = core.execute_primitive(
                state.phys, core.step_decode_waypoints(action))
        else:
            state, f_target = core.step_decode_pre(state, action)
            q_target = core.arm_targets(state)
            # the chest door's hold-open motor (zero without a chest)
            door_target = torch.full_like(
                state.phys.door_q,
                self.cfg.chest_door_opened_state if self.cfg.has_chest
                else 0.0)
            phys = core.engine.control_step(state.phys, D.Controls(
                q_target=q_target, f_target=f_target,
                door_motor_on=state.door_hold_open, door_target=door_target))
        state = state._replace(phys=phys, steps=state.steps + 1,
                               host_steps=state.host_steps + 1)
        state, obs, reward, achieved = core.step_finish(state, self.generator)
        done = state.steps >= self.max_episode_steps
        info = {'goal_achieved': achieved}
        if self.auto_reset and state.host_steps >= self.max_episode_steps:
            state, _ = self._auto_reset(state)
        return state, obs, reward, done, info

    @property
    def action_space(self):
        if self.cfg.primitive == 'discrete_push':
            # MultiDiscrete([20, W, H]) (kuka.py:89-97)
            return spaces.MultiDiscrete((20, self.core.action_map_width,
                                         self.core.action_map_height))
        return spaces.Box.unit(self.cfg.action_dim)

    def observation_space(self, obs):
        """A Dict space sized from a sample obs (batch axis dropped)."""
        return spaces.Dict({k: spaces.Box.unbounded(tuple(v.shape[1:]) or (1,))
                            for k, v in obs.items() if not isinstance(v, dict)})


def make_vec_env(num_envs: int = 1, device=None, **kwargs) -> VecMGEnv:
    """``make_vec_env(num_envs=4096, task='push')``: the batched env on
    ``device`` (default CUDA). Keywords that are `EnvConfig` fields configure
    the task; ``seed`` and ``auto_reset`` go to `VecMGEnv`."""
    cfg_fields = set(EnvConfig.__dataclass_fields__)
    cfg_kwargs = {k: v for k, v in kwargs.items() if k in cfg_fields}
    rest = {k: v for k, v in kwargs.items() if k not in cfg_fields}
    return VecMGEnv(EnvConfig(**cfg_kwargs), num_envs=num_envs, device=device,
                    **rest)
