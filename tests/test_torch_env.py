"""The port's main path against the JAX package's, on the CPU.

The JAX side runs the same sequence as its fused-kernel step
(`envs/vec_env.py`), with the XLA oracles standing in for the kernels:
``step_decode_pre`` -> ``ik.solve(num_iters=8)`` -> 100 x ``Engine.substep``
-> ``step_finish``, all vmapped. Both start from the same JAX-reset state,
carried across in the path-keyed checkpoint format (`interop.py`), and take
the same seeded actions. Torch's RNG cannot reproduce JAX keys, so the
port's resets are checked by their invariants instead.

Tolerances: observations 5e-3 after 3 steps (tests/test_pallas_engine.py);
rewards equal except where the goal distance is within 5e-3 of the
threshold; ``done`` equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pybullet_multigoal_gym_tpu  # noqa: F401  (JAX precision config)
from pybullet_multigoal_gym_tpu.config import EnvConfig as JaxConfig
from pybullet_multigoal_gym_tpu.envs.single_step import KukaSingleStepEnv
from pybullet_multigoal_gym_tpu.ops import dynamics as JD
from pybullet_multigoal_gym_tpu.ops import ik as jik
from pybullet_multigoal_gym_tpu.utils import checkpoint
from pybullet_multigoal_gym_tpu_torch import make_vec_env
from pybullet_multigoal_gym_tpu_torch.interop import (state_from_numpy,
                                                      state_to_numpy)
from pybullet_multigoal_gym_tpu_torch.model import kuka_model as KM
from tests.torch_common import n, t

torch.set_num_threads(1)

N_ENVS, N_STEPS = 8, 3


def _jax_main_path(env):
    """The fused-kernel step sequence with the XLA oracles, vmapped."""
    rest = jnp.asarray(env.rest_pose)

    def substeps(s, c):
        return jax.lax.fori_loop(0, 100, lambda i, x: env.engine.substep(x, c),
                                 s)

    def step(state, action):
        state, f_t = jax.vmap(env.step_decode_pre)(state, action)
        q_t = jax.vmap(lambda tgt, q: jik.solve(tgt, q_init=q, rest_pose=rest,
                                                num_iters=8))(
            state.ee_target, state.phys.q)
        zeros = jnp.zeros(action.shape[:1], jnp.float32)
        phys = jax.vmap(substeps)(state.phys, JD.Controls(
            q_target=q_t, f_target=f_t, door_motor_on=zeros > 0,
            door_target=zeros))
        state = state._replace(phys=phys, steps=state.steps + 1)
        state, obs, reward, _ = jax.vmap(env.step_finish)(state)
        return state, obs, reward, state.steps >= env.cfg.max_episode_steps

    return jax.jit(step)


@pytest.fixture(scope='module', params=['push', 'reach'])
def slice_run(request, tmp_path_factory):
    """JAX reset state (as checkpoint leaves), actions, and the JAX main
    path's outputs after each of 3 steps."""
    task = request.param
    env = KukaSingleStepEnv(JaxConfig(task=task))
    keys = jax.random.split(jax.random.PRNGKey(0), N_ENVS)
    state, _ = jax.jit(jax.vmap(env.reset))(keys)
    path = str(tmp_path_factory.mktemp(task) / 'state')
    checkpoint.save(path, state)
    with np.load(path + '.npz') as f:
        leaves = dict(f)
    rng = np.random.default_rng(0)
    actions = rng.uniform(-1, 1, (N_STEPS, N_ENVS, env.cfg.action_dim)
                          ).astype(np.float32)
    step = _jax_main_path(env)
    outs = []
    for a in actions:
        state, obs, reward, done = step(state, jnp.asarray(a))
        outs.append(jax.tree_util.tree_map(np.asarray, (obs, reward, done)))
    return task, env, leaves, actions, outs


def test_interop_round_trip(slice_run):
    _, _, leaves, _, _ = slice_run
    back = state_to_numpy(state_from_numpy(leaves, device='cpu'))
    assert sorted(back) == sorted(k for k in leaves if k != '.key')
    for k, v in back.items():
        assert v.dtype == leaves[k].dtype, k
        np.testing.assert_array_equal(v, leaves[k], err_msg=k)


def test_rest_pose_matches_jax(slice_run):
    task, jenv, _, _, _ = slice_run
    env = make_vec_env(num_envs=1, task=task, device='cpu')
    np.testing.assert_allclose(env.core.rest_pose, jenv.rest_pose, atol=1e-5)
    np.testing.assert_allclose(env.core.tip_rest, jenv.tip_rest, atol=1e-5)


def test_main_path_matches_jax(slice_run):
    task, jenv, leaves, actions, outs = slice_run
    env = make_vec_env(num_envs=N_ENVS, task=task, device='cpu')
    state = state_from_numpy(leaves, device='cpu')
    for a, (jobs, jrew, jdone) in zip(actions, outs):
        state, obs, reward, done, info = env.step(state, t(a))
        for k in ('observation', 'policy_state', 'achieved_goal',
                  'desired_goal'):
            np.testing.assert_allclose(n(obs[k]), jobs[k], atol=5e-3,
                                       err_msg=k)
        d = np.linalg.norm(jobs['achieved_goal'] - jobs['desired_goal'],
                           axis=-1)
        sure = np.abs(d - jenv.cfg.distance_threshold) >= 5e-3
        np.testing.assert_array_equal(n(reward)[sure], jrew[sure])
        np.testing.assert_array_equal(n(done), jdone)
    assert env.core.ik.launches == 0 and env.core.engine.launches == 0


def test_joint_control_step():
    """Under joint control an action moves the joint target by 0.05 rad per
    unit (clipped to [-1, 1]), the servo tracks it without IK, the EE target
    stays, and the observation starts with the joint angles."""
    env = make_vec_env(num_envs=2, task='reach', joint_control=True,
                       device='cpu')
    state, obs = env.reset()
    assert tuple(obs['observation'].shape) == (2, 10)
    action = torch.tensor([[2.0, -1.0, 0.5, 0.0, 0.25, -0.5, 1.0],
                           [-0.3, 0.3, -0.3, 0.3, -0.3, 0.3, -0.3]])
    new, obs, _, _, _ = env.step(state, action)
    np.testing.assert_allclose(
        n(new.joint_target),
        n(state.joint_target + 0.05 * action.clamp(-1.0, 1.0)), atol=1e-7)
    np.testing.assert_array_equal(n(new.ee_target), n(state.ee_target))
    np.testing.assert_array_equal(n(obs['observation'][:, :7]), n(new.phys.q))
    # the arm moved toward the new joint target
    moved = n(new.phys.q - state.phys.q) * n(action.clamp(-1.0, 1.0))
    assert (moved[np.abs(n(action)) > 0] > 0).all()


@pytest.mark.parametrize('task', ['push', 'reach', 'pick_and_place'])
def test_reset_invariants(task):
    count = 512
    env = make_vec_env(num_envs=count, task=task, device='cpu', seed=3)
    core = env.core
    state, obs = env.reset()
    has_obj = task != 'reach'
    dims = {'observation': 20 if has_obj else 3,
            'policy_state': 7 if has_obj else 3,
            'achieved_goal': 3, 'desired_goal': 3}
    assert {k: tuple(v.shape) for k, v in obs.items()} == {
        k: (count, d) for k, d in dims.items()}
    space = env.observation_space(obs)
    assert {k: space[k].shape for k in space.keys()} == {
        k: (d,) for k, d in dims.items()}
    assert env.action_space.shape == (env.cfg.action_dim,)
    assert env.action_space.contains(np.zeros(env.cfg.action_dim))
    goal = n(state.desired_goal)
    assert (goal >= core.target_lower - 1e-6).all()
    assert (goal <= core.target_upper + 1e-6).all()
    if has_obj:
        obj = n(state.phys.body_pos[:, 0])
        assert (obj[:, :2] >= core.object_lower[:2] - 1e-6).all()
        assert (obj[:, :2] <= core.object_upper[:2] + 1e-6).all()
        np.testing.assert_allclose(obj[:, 2], core.block_z, atol=1e-7)
        assert (np.linalg.norm(obj[:, :2] - core.tip_initial[:2], axis=-1)
                > 0.1).all()
        center = obj
    else:
        center = core.tip_initial
    # the 0.1 m exclusion holds for the drawn goal, before a goal on the
    # table has its z set to the block height (as in the JAX package)
    on_table = np.isclose(goal[:, 2], core.block_z, atol=1e-7)
    drawn = ~on_table if task != 'reach' else np.ones(count, bool)
    assert (np.linalg.norm(goal - center, axis=-1)[drawn] > 0.1).all()
    if task == 'push':
        assert on_table.all()
    elif task == 'pick_and_place':
        # half of the targets on the table, the rest in the air
        assert 0.35 < on_table.mean() < 0.65
    np.testing.assert_allclose(n(state.phys.q),
                               np.broadcast_to(core.rest_pose, (count, 7)))
    np.testing.assert_allclose(n(state.phys.fq), KM.FINGER_LIMIT, atol=1e-7)
    assert (n(state.steps) == 0).all() and state.host_steps == 0
    # a reseeded reset repeats itself; the next one differs
    again, _ = env.reset(seed=3)
    np.testing.assert_array_equal(n(again.desired_goal), goal)
    other, _ = env.reset()
    assert not np.allclose(n(other.desired_goal), goal)


def test_time_limit_resets_every_env():
    """Every env reports done at step 50 (not before) and comes back as a
    fresh episode. The episode is started at step 47 to keep the CPU run
    short: ``done`` depends only on the step count."""
    env = make_vec_env(num_envs=4, task='reach', device='cpu')
    assert env.max_episode_steps == 50
    state, _ = env.reset()
    state = state._replace(steps=torch.full_like(state.steps, 47),
                           host_steps=47)
    action = torch.zeros((4, env.cfg.action_dim))
    for step in (48, 49, 50):
        old_goal = n(state.desired_goal)
        state, obs, reward, done, info = env.step(state, action)
        assert n(done).tolist() == [step == 50] * 4
    # the last step's obs belong to the finished episode; the state is new
    np.testing.assert_array_equal(n(obs['desired_goal']), old_goal)
    assert (n(state.steps) == 0).all() and state.host_steps == 0
    assert not np.allclose(n(state.desired_goal), old_goal)
    np.testing.assert_allclose(n(state.phys.q),
                               np.broadcast_to(env.core.rest_pose, (4, 7)))
    assert (n(state.phys.qd) == 0).all()


def test_time_limit_without_auto_reset():
    """With ``auto_reset=False`` the TimeLimit still reports ``done``, and
    the state is not reset: the step count reaches 50 and the goal stays."""
    env = make_vec_env(num_envs=2, task='reach', device='cpu',
                       auto_reset=False)
    state, _ = env.reset()
    goal = n(state.desired_goal)
    state = state._replace(steps=torch.full_like(state.steps, 49),
                           host_steps=49)
    state, _, _, done, _ = env.step(state, torch.zeros((2, 3)))
    assert n(done).all()
    assert (n(state.steps) == 50).all() and state.host_steps == 50
    np.testing.assert_array_equal(n(state.desired_goal), goal)


@pytest.mark.parametrize('task', ['slide'])
def test_later_slices_raise(task):
    """Image observations come with a later slice, and so does the
    Robotiq-85 gripper on the push primitives, insertion and the chest;
    slide, the last single-step task, builds (on K2's cylinder lanes), and
    so does push with the Robotiq-85."""
    assert make_vec_env(num_envs=2, task=task, device='cpu').core.scene \
        .has_body
    with pytest.raises(NotImplementedError, match='later slice'):
        make_vec_env(num_envs=2, task='push', image_observation=True,
                     device='cpu')
    assert make_vec_env(num_envs=2, task='push', gripper='robotiq85',
                        device='cpu').core.scene.gripper == 'robotiq85'
    for kw in (dict(task='insertion'), dict(task='chest_push', num_block=1),
               dict(task='primitive_push_reach', primitive='continuous_push')):
        with pytest.raises(NotImplementedError, match='later slice'):
            make_vec_env(num_envs=2, gripper='robotiq85', device='cpu', **kw)
