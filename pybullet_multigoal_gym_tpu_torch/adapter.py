"""Single-env, numpy-in/numpy-out adapter with the classic Gym surface.

Counterpart of `pybullet_multigoal_gym_tpu/adapter.py`: users of the
reference (`env = make_env(...)`; `obs = env.reset()`; `obs, reward, done,
info = env.step(action)`) get a drop-in object backed by the batched env
(`VecMGEnv` with one env and no auto-reset), on the card unless the caller
passes ``device='cpu'``. Also carries the reference's auxiliary public API:
`set_sub_goal`, `activate_curriculum_update`, `deactivate_curriculum_update`
and `step_demonstrator` (`kuka_multi_step_base_env.py:113-181`).
"""

import warnings

import numpy as np
import torch

from pybullet_multigoal_gym_tpu_torch.config import EnvConfig
from pybullet_multigoal_gym_tpu_torch.envs.vec_env import VecMGEnv
from pybullet_multigoal_gym_tpu_torch.utils import spaces
from pybullet_multigoal_gym_tpu_torch.utils.demonstrator import (
    StepDemonstrator, default_demonstrations)


def _first(obs):
    """A batched observation's first env as numpy, one level of dicts deep
    (insertion's ``subtask_rewards``)."""
    return {k: ({kk: vv[0].cpu().numpy() for kk, vv in v.items()}
                if isinstance(v, dict) else v[0].cpu().numpy())
            for k, v in obs.items()}


class GymStyleEnv:
    """One logical env with the reference's gym-era API. Its random draws
    come from the batched env's `torch.Generator`, seeded by ``seed``."""

    def __init__(self, cfg: EnvConfig, seed: int = 0, device=None):
        # no auto-reset: classic gym semantics (the user calls reset())
        self.venv = VecMGEnv(cfg, num_envs=1, device=device, seed=seed,
                             auto_reset=False)
        self.cfg = cfg
        self.env_id = self.venv.env_id
        self._state = None
        self.action_space = self.venv.action_space
        self.observation_space = None
        self._max_episode_steps = cfg.max_episode_steps
        if cfg.task_decomposition:
            self.step_demonstrator = StepDemonstrator(
                default_demonstrations(cfg.num_steps))

    # --------------------------------------------------------------- gym api
    def seed(self, seed=None):
        if seed is not None:
            self.venv.generator.manual_seed(seed)
        return [seed]

    def reset(self, test: bool = False):
        if self.cfg.family == 'multi_step':
            # the curriculum's bookkeeping carries across the resets
            s, curr = self._state, None
            if s is not None:
                curr = (s.curriculum_prob, s.goals_generated,
                        s.curriculum_update)
            self._state, obs = self.venv.core.reset(1, self.venv.generator,
                                                    curr=curr)
        else:
            self._state, obs = self.venv.reset()
        obs = _first(obs)
        if self.observation_space is None:
            self.observation_space = spaces.Dict({
                ('state' if k == 'observation' and not self.cfg.image_observation
                 else k): spaces.Box.unbounded(np.asarray(v).shape)
                for k, v in obs.items() if not isinstance(v, dict)})
        return obs

    def step(self, action):
        assert self._state is not None, 'call reset() before step()'
        a = torch.as_tensor(np.asarray(action, np.float32),
                            device=self.venv.device)[None]
        self._state, obs, reward, done, info = self.venv.step(self._state, a)
        info = {'goal_achieved': bool(info['goal_achieved'][0])}
        # env-level done is always False; TimeLimit truncates (base_env.py:138)
        return _first(obs), float(reward[0]), bool(done[0]), info

    def render(self, mode='human', camera_id=0):
        if mode == 'human':
            # the reference warns and returns: GUI rendering is a
            # construction-time choice there (base_env.py:143-145)
            warnings.warn('render(mode="human") does nothing in the port; '
                          'images come with its render slice')
            return np.array([])
        raise NotImplementedError('render(mode=%r) comes with the render '
                                  'slice of the port' % (mode,))

    def close(self):
        self._state = None

    @property
    def dt(self):
        return 0.002 * 20

    # ------------------------------------------------- reference extras
    def set_sub_goal(self, sub_goal_ind):
        if not self.cfg.task_decomposition:
            warnings.warn(
                'The set_sub_goal() method should only be called when using '
                'task decomposition,\nIt does nothing and returns None when '
                'task_decomposition is False.')
            return None
        self._state = self.venv.core.set_sub_goal(self._state,
                                                  int(sub_goal_ind))
        return self._state.desired_goal[0].cpu().numpy()

    def activate_curriculum_update(self):
        self._set_curriculum_update(True)

    def deactivate_curriculum_update(self):
        self._set_curriculum_update(False)

    def _set_curriculum_update(self, value: bool):
        if not self.cfg.use_curriculum:
            warnings.warn('This method should not be called while not using '
                          'curriculum.')
            return
        flags = torch.full_like(self._state.curriculum_update, value)
        self._state = self._state._replace(curriculum_update=flags)

