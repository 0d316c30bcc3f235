"""The port's front, `make_env` and `GymStyleEnv`, against the JAX package's
(`pybullet_multigoal_gym_tpu/__init__.py`, `adapter.py`) on the CPU.

The env ids, the printed ``Task id`` line and the keyword checks are held
against the JAX package's `make_env` and `env_id`; that side is numpy only
(its `make_env` is called only where it raises before building an env), so
nothing is compiled. The adapter is held to the classic gym surface and to
the batched env it wraps (`VecMGEnv` with one env and no auto-reset),
driven from the same seed.
"""

import warnings

import numpy as np
import pytest
import torch

import pybullet_multigoal_gym_tpu as jpmg
from pybullet_multigoal_gym_tpu.config import EnvConfig as JaxConfig
import pybullet_multigoal_gym_tpu_torch as port
from pybullet_multigoal_gym_tpu_torch import EnvConfig, GymStyleEnv, VecMGEnv
from pybullet_multigoal_gym_tpu_torch.config import TASKS
from pybullet_multigoal_gym_tpu_torch.utils.demonstrator import (
    StepDemonstrator)
from tests.torch_common import n

torch.set_num_threads(1)

# keyword sets beyond the task: make_env's (render is an id tag only)
KEYWORDS = ({}, {'joint_control': True, 'binary_reward': False},
            {'render': True, 'max_episode_steps': 10})


def _task_kw(task):
    return {'primitive': 'discrete_push'} if task.startswith('primitive') \
        else {}


@pytest.mark.parametrize('task', TASKS)
def test_env_ids_match_jax(task, capsys):
    for kw in KEYWORDS:
        kw = dict(kw, **_task_kw(task))
        env = port.make_env(task=task, device='cpu', **kw)
        render = kw.pop('render', False)
        cfg = JaxConfig(task=task, **kw)
        # the printed id carries the render tag, the env's own does not
        # (the JAX adapter takes its batched env's)
        printed = jpmg.env_id(cfg, render=render)
        assert isinstance(env, GymStyleEnv)
        assert env.env_id == jpmg.env_id(cfg) == env.venv.env_id
        assert capsys.readouterr().out == 'Task id: %s\n' % printed
        assert port.registry[printed] == env.cfg


def _assertion(fn, **kw):
    """The AssertionError message of ``fn(**kw)`` (None if none)."""
    try:
        fn(**kw)
    except AssertionError as e:
        return str(e)
    return None


CAMERAS = [dict(cameraEyePosition=[-1.0, 0.0, 0.5],
                cameraTargetPosition=[-0.5, 0.0, 0.2],
                cameraUpVector=[0.0, 0.0, 1.0], render_width=64,
                render_height=64)]


@pytest.mark.parametrize('kw', [
    dict(task='slide', image_observation=True),
    dict(task='push', image_observation=True, camera_setup=CAMERAS,
         observation_cam_id=[0, 1, 2]),
    dict(task='push', image_observation=True, camera_setup=CAMERAS,
         goal_cam_id=1),
], ids=['slide-image', 'observation-cam-id', 'goal-cam-id'])
def test_make_env_assertions_match_jax(kw):
    """The slide image assertion and the camera-id checks fire before any
    env is built, with the JAX package's messages."""
    want = _assertion(jpmg.make_env, **kw)
    assert want is not None
    assert _assertion(port.make_env, device='cpu', **kw) == want


def test_make_env_num_envs_and_device():
    """``num_envs`` gives the batched env; ``device=None`` asks for CUDA
    and raises without it, as `make_vec_env` does."""
    vec = port.make_env(task='slide', num_envs=3, device='cpu', seed=2)
    assert isinstance(vec, VecMGEnv) and vec.num_envs == 3
    assert vec.core.scene.geom_type == 1 and vec.auto_reset
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            port.make_env(task='reach')
    # what still raises, naming a later slice
    with pytest.raises(NotImplementedError, match='later slice'):
        port.make_env(task='insertion', gripper='robotiq85', device='cpu')
    with pytest.raises(NotImplementedError, match='later slice'):
        port.make_env(task='push', image_observation=True, device='cpu')


@pytest.fixture(scope='module')
def reach_pair():
    """A reach `GymStyleEnv` and the batched env it stands for, seed 3,
    reset and stepped once with the same action."""
    env = port.make_env(task='reach', device='cpu', seed=3)
    venv = VecMGEnv(EnvConfig(task='reach'), num_envs=1, device='cpu',
                    seed=3, auto_reset=False)
    action = np.array([0.4, -0.7, 0.2], np.float32)
    obs0 = env.reset()
    vstate, vobs0 = venv.reset()
    out = env.step(action)
    vout = venv.step(vstate, torch.as_tensor(action)[None])
    return env, obs0, out, vobs0, vout


def test_gym_api_types(reach_pair):
    env, obs0, (obs, reward, done, info), _, _ = reach_pair
    for o in (obs0, obs):
        assert set(o) == {'observation', 'policy_state', 'achieved_goal',
                          'desired_goal'}
        assert all(isinstance(v, np.ndarray) and v.dtype == np.float32
                   for v in o.values())
        assert o['observation'].shape == (3,)
    assert type(reward) is float and reward in (-1.0, 0.0)
    assert type(done) is bool and not done
    assert set(info) == {'goal_achieved'}
    assert type(info['goal_achieved']) is bool
    # the reference's `state` key for the observation
    assert sorted(env.observation_space.keys()) == [
        'achieved_goal', 'desired_goal', 'policy_state', 'state']
    assert env.observation_space['state'].shape == (3,)
    assert env.action_space.shape == (3,)
    assert env.dt == pytest.approx(0.04)
    assert env._max_episode_steps == 50


def test_gym_env_equals_batched_env(reach_pair):
    """Reset and step give what `VecMGEnv(num_envs=1, auto_reset=False)`
    gives from the same seed, as numpy."""
    _, obs0, (obs, reward, done, info), vobs0, vout = reach_pair
    _, vobs, vreward, vdone, vinfo = vout
    for k in obs0:
        np.testing.assert_array_equal(obs0[k], n(vobs0[k])[0])
        np.testing.assert_array_equal(obs[k], n(vobs[k])[0])
    assert reward == float(vreward[0]) and done == bool(vdone[0])
    assert info['goal_achieved'] == bool(vinfo['goal_achieved'][0])


def test_gym_env_seed_close_and_render():
    env = port.make_env(task='push', device='cpu', seed=1)
    with pytest.raises(AssertionError, match='reset'):
        env.step(np.zeros(3, np.float32))
    goal = env.reset()['desired_goal']
    assert not np.array_equal(env.reset()['desired_goal'], goal)
    assert env.seed(1) == [1]
    np.testing.assert_array_equal(env.reset()['desired_goal'], goal)
    with pytest.raises(NotImplementedError, match='render slice'):
        env.render(mode='rgb_array')
    with pytest.warns(UserWarning, match='does nothing'):
        assert env.render(mode='human').shape == (0,)
    env.close()
    assert env._state is None


def test_gym_env_sub_goals_and_curriculum():
    """The reference's extras on one-env multi-step tasks (reset only):
    `set_sub_goal` pins the goal to a sub-goal under task decomposition and
    warns otherwise; the curriculum toggles set the flag and warn without a
    curriculum; the curriculum survives a reset."""
    env = port.make_env(task='block_stack', num_block=2,
                        task_decomposition=True, device='cpu')
    assert isinstance(env.step_demonstrator, StepDemonstrator)
    obs = env.reset()
    sub = n(env._state.sub_goals[0])
    np.testing.assert_array_equal(env.set_sub_goal(0), sub[0])
    np.testing.assert_array_equal(env._state.desired_goal[0], sub[0])
    np.testing.assert_array_equal(env.set_sub_goal(-1), sub[-1])
    assert obs['desired_goal'].shape == sub[0].shape
    with pytest.warns(UserWarning, match='curriculum'):
        env.activate_curriculum_update()

    env = port.make_env(task='block_rearrange', num_block=2,
                        use_curriculum=True, device='cpu')
    assert not hasattr(env, 'step_demonstrator')
    env.reset()
    with pytest.warns(UserWarning, match='task decomposition'):
        assert env.set_sub_goal(0) is None
    env.activate_curriculum_update()
    assert bool(env._state.curriculum_update[0])
    prob = n(env._state.curriculum_prob)
    env.reset()
    assert bool(env._state.curriculum_update[0])
    np.testing.assert_array_equal(n(env._state.curriculum_prob), prob)
    env.deactivate_curriculum_update()
    assert not bool(env._state.curriculum_update[0])
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        env.deactivate_curriculum_update()
