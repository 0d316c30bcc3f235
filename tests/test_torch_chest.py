"""The port's chest slice against the JAX package, on the CPU: kernel K3's
plain version (`ops/multibody_plain.py`) with the chest's static walls and
its prismatic door, and the chest_push and chest_pick_and_place envs
(`envs/multi_step.py`).

The JAX side of the physics is the XLA engine (`ops/dynamics.py:Engine`),
whose contact plan uses the same one-sided 5 + 1 lanes for a wall or a door
panel, the same two-sided 9-lane SAT for a pad on a door panel and the same
door servo, mass splitting and stops as the Pallas kernel K3 (the Pallas
test of K3 runs only on a TPU). It is compiled once per scene for the module
(a vmapped loop of substeps with a traced trip count), at 1 and 2 blocks;
its plan puts the lanes in another order, so the two sum in other orders.
The envs run the JAX package's batched step sequence around it
(``step_decode_pre`` -> ``ik.solve(num_iters=8)`` -> 100 substeps with the
door's motor on where the hold-open latch is set -> ``step_finish``), from
one state carried across in the path-keyed checkpoint format (`interop.py`).
Torch's RNG cannot reproduce JAX keys, so resets are checked by their
invariants.

Tolerances: the state 2e-3 after 2 and 100 substeps (the bound the JAX
package holds its Pallas engines to against its XLA engine; the EE force as
its impulse, force x dt; the door's joint and velocity too); the door frame
and keypoints 1e-6; observations 5e-3 after 3 steps, rewards and the latch
equal where the goal distance, or the door's distance from its open state,
lies 5e-3 or more from its threshold; goals and sub-goals 1e-6 from the
same state.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pybullet_multigoal_gym_tpu  # noqa: F401  (JAX precision config)
from pybullet_multigoal_gym_tpu.config import EnvConfig as JaxConfig
from pybullet_multigoal_gym_tpu.envs import multi_step as jms
from pybullet_multigoal_gym_tpu.ops import dynamics as JD
from pybullet_multigoal_gym_tpu.ops import lane_cull as JLC
from pybullet_multigoal_gym_tpu.ops import pallas_multibody as PM
from pybullet_multigoal_gym_tpu.ops import scene as JS
from pybullet_multigoal_gym_tpu_torch import make_vec_env
from pybullet_multigoal_gym_tpu_torch.config import EnvConfig
from pybullet_multigoal_gym_tpu_torch.interop import state_to_numpy
from pybullet_multigoal_gym_tpu_torch.ops import dynamics as D
from pybullet_multigoal_gym_tpu_torch.ops import multibody_plain as MP
from pybullet_multigoal_gym_tpu_torch.ops import scene as S
from tests.test_torch_multibody import _jax_tree, _solve, _to_jax_state
from tests.torch_common import (ARM_FIELDS, BODY_FIELDS, CHEST_DOOR,
                                chest_inputs, n, plain_run, t, torch_controls,
                                torch_state)

torch.set_num_threads(1)

DOORS = ('front_sliding', 'up_sliding')
KINDS = ('drop', 'handle', 'door_block', 'hold_open', 'spawn')
# the lane groups the chest brings
CHEST_GROUPS = ('box-static', 'box-door', 'finger-door', 'finger-static',
                'sphere-static', 'sphere-door')
# envs per state in the engine checks, per env batch in the env checks
N_STATE, N_ENVS, N_STEPS = 4, 4, 3
DOOR_FIELDS = ('door_q', 'door_qd')


def _scene(door, nb, joint_control=False):
    return D.multibody_consts(S.multi_step_scene(nb, True, door),
                              ik_workspace=not joint_control)


# ------------------------------------------------------------ the plan
# pallas_multibody.count_lanes of the chest scenes at 1-5 blocks, EE control
PLAN_SIZES = {'front_sliding': (146, 212, 288, 374, 470),
              'up_sliding': (166, 239, 322, 415, 518)}


@pytest.mark.parametrize('door', DOORS)
@pytest.mark.parametrize('joint_control', [False, True])
@pytest.mark.parametrize('nb', [1, 2, 3, 4, 5])
def test_lane_plan_matches_pallas_count(door, joint_control, nb):
    """The plain version's lanes are the Pallas kernel's: as many (the
    largest plan, chest_pick_and_place with 5 blocks under joint control,
    has 558), the one-sided lanes of each free geom against the walls and
    the door's panels after its fingers, then the pads on the door's
    panels, each pad's plane lanes followed by its wall lanes."""
    sc = _scene(door, nb, joint_control)
    plan = MP.lane_plan(sc)
    assert len(plan) == PM.count_lanes(JS.multi_step_scene(nb, True, door),
                                       ik_workspace=not joint_control)
    if not joint_control:
        assert len(plan) == PLAN_SIZES[door][nb - 1]
    if (door, nb, joint_control) == ('up_sliding', 5, True):
        assert len(plan) == 558
    groups = [MP.lane_group(lane) for lane in plan]
    ns = sc.ns
    head = (['box-plane'] * 4 + ['finger-box'] * 18 + ['box-static'] * 6 * ns
            + ['box-door'] * 12) * nb
    head += ['box-box'] * (10 * nb * (nb - 1) // 2) + ['finger-door'] * 36
    head += (['finger-plane'] * 4 + ['finger-static'] * 5 * ns) * 2
    assert groups[:len(head)] == head
    assert set(groups[len(head):]) <= {'sphere-plane', 'sphere-box',
                                       'sphere-static', 'sphere-door'}
    # the finger-static lanes couple the arm, the finger-door ones do not
    on = {g: {MP.couple(lane.side_a, lane.side_b)
              for lane, gg in zip(plan, groups) if gg == g}
          for g in ('finger-static', 'finger-door')}
    assert on == {'finger-static': {1.0}, 'finger-door': {0.0}}


@pytest.mark.parametrize('door', DOORS)
def test_chest_consts_match_xla_engine(door):
    """The walls, the door's frame, limit, mass and panels, and the arm
    spheres kept against each, as the XLA engine and `lane_cull` have
    them."""
    spec, jspec = S.multi_step_scene(2, True, door), JS.multi_step_scene(
        2, True, door)
    sc = D.multibody_consts(spec)
    eng = JD.Engine(jspec)
    np.testing.assert_array_equal(np.float32(sc.static_half), eng.static_half)
    np.testing.assert_array_equal(np.float32(sc.static_pos), eng.static_pos)
    np.testing.assert_array_equal(np.float32(sc.static_friction),
                                  eng.static_fric)
    np.testing.assert_allclose(sc.door_anchor, eng.door_anchor, atol=1e-7)
    np.testing.assert_array_equal(sc.door_axis, eng.door_axis)
    np.testing.assert_array_equal(np.float32(sc.door_half), eng.door_geom_half)
    np.testing.assert_array_equal(np.float32(sc.door_pos), eng.door_geom_pos)
    assert (sc.door_inv_mass, sc.door_limit) == (eng.door_inv_mass,
                                                 eng.door.limit)
    reach = JLC.arm_lane_mask(jspec, True)
    for s in range(sc.ns):
        assert [sc.static_mask[s] >> sp & 1 for sp in range(7)] == [
            int(reach['static'][sp][s]) for sp in range(7)]
    assert [sc.door_mask >> sp & 1 for sp in range(7)] == [
        int(x) for x in reach['door']]


@pytest.mark.parametrize('door', DOORS)
def test_door_frame_matches_jax(door):
    """`door_frame` and `door_point_jac` against the XLA engine's, over the
    door's range: 1e-6."""
    sc = _scene(door, 1)
    eng = JD.Engine(JS.multi_step_scene(1, True, door))
    rng = np.random.default_rng(0)
    q = rng.uniform(0.0, sc.door_limit, 16).astype(np.float32)
    pts = rng.uniform(-0.7, 0.3, (16, 3)).astype(np.float32)
    pos, rot = sc.door_frame(t(q))
    jpos, jrot = jax.vmap(eng.door_frame)(jnp.asarray(q))
    np.testing.assert_allclose(n(pos), np.asarray(jpos), atol=1e-6)
    np.testing.assert_array_equal(n(rot), np.asarray(jrot))
    np.testing.assert_array_equal(
        n(sc.door_point_jac(t(pts), t(q))),
        np.asarray(eng.door_point_jac(jnp.asarray(pts), jnp.asarray(q))))


def test_unported_door_raises():
    """The revolving door (built by no task) comes with a later slice."""
    with pytest.raises(NotImplementedError, match='later slice'):
        D.multibody_consts(S.multi_step_scene(2, True, 'revolving'))


# -------------------------------------------------- against the XLA engine
@functools.lru_cache(maxsize=None)
def _xla(nb, door):
    """The XLA engine of the chest scene, compiled once per module:
    ``run(state, controls, n_substeps)`` over a batch."""
    eng = JD.Engine(JS.multi_step_scene(nb, True, door))
    return jax.jit(jax.vmap(
        lambda s, c, k: jax.lax.fori_loop(0, k, lambda i, x: eng.substep(x, c),
                                          s), in_axes=(0, 0, None)))


def _all_states(door, nb):
    """The chest stress states (tests/torch_common.py:chest_inputs) of
    N_STATE envs each, as one batch (numpy)."""
    parts = [chest_inputs(door, nb, kind, N_STATE, seed=4) for kind in KINDS]
    return [{k: np.concatenate([p[i][k] for p in parts]) for k in parts[0][i]}
            for i in range(2)]


def _hold_to_xla(out, ref):
    for f in ARM_FIELDS + BODY_FIELDS + DOOR_FIELDS:
        np.testing.assert_allclose(n(getattr(out, f)), n(getattr(ref, f)),
                                   atol=2e-3, err_msg=f)
    np.testing.assert_allclose(n(out.ee_contact_force),
                               n(ref.ee_contact_force), atol=2e-3 / D.DT_SUB)


# (door, blocks, the env that then takes 3 steps on the same compiled XLA
# engine: an engine's compile is most of a case's time)
XLA_CASES = [('front_sliding', 1, None), ('front_sliding', 2, 'chest_push'),
             ('up_sliding', 1, 'chest_pick_and_place'), ('up_sliding', 2, None)]


@pytest.mark.parametrize('door,nb,task', XLA_CASES)
def test_control_step_plain_matches_xla(door, nb, task):
    """Every chest stress state, 2 substeps (and 100 at 1 block, where none
    of them is chaotic): the blocks dropped beside and inside the open
    chest, the pads sweeping the handle, a block pressed against the closed
    door (by the pads, or while the pads hold the handle), the door's motor
    holding it against its stop while the arm leans on a wall, and the
    reset pose. Each lane group the chest brings acts in some env; the door
    moves. Then, for chest_push with 2 blocks and chest_pick_and_place with
    1, the env's main path (`_main_path_matches_jax`)."""
    st, ctl = _all_states(door, nb)
    jst, jctl = _jax_tree(JD.PhysicsState, st), _jax_tree(JD.Controls, ctl)
    sc = _scene(door, nb)
    out, active = plain_run(sc, torch_state(st), torch_controls(ctl), 2)
    _hold_to_xla(out, _xla(nb, door)(jst, jctl, 2))
    assert all(active.get(g, 0.0) > 0 for g in CHEST_GROUPS), active
    assert (n(out.door_q) != st['door_q']).any()
    assert np.abs(n(out.ee_contact_force)).max() > 1.0
    if nb == 1:
        out = MP.control_step(sc, torch_state(st), torch_controls(ctl), 100)
        _hold_to_xla(out, _xla(nb, door)(jst, jctl, 100))
    if task is not None:
        _main_path_matches_jax(task, nb)


# -------------------------------------------------- the env's main path
def _jax_env(task, nb, **kw):
    return _jax_env_of(JaxConfig(task=task, num_block=nb, **kw))


@functools.lru_cache(maxsize=None)
def _jax_env_of(cfg):
    """The JAX env of ``cfg``, built once per module (building it solves
    its rest pose, about 5 s on the CPU)."""
    return jms.KukaMultiBlockEnv(cfg)


def _main_path_matches_jax(task, nb):
    """3 seeded steps of the port (plain path) and of the JAX package's step
    sequence from one port reset state, in half of the envs with the door
    5 mm from its open state, so that the latch sets after the first step
    and the door's motor holds it open in the next two."""
    env = make_vec_env(num_envs=N_ENVS, task=task, num_block=nb,
                       device='cpu', seed=1)
    state, _ = env.reset()
    opened = env.cfg.chest_door_opened_state
    near = torch.arange(N_ENVS) % 2 == 0
    state = state._replace(phys=state.phys._replace(door_q=torch.where(
        near, opened - 0.005, 0.0)))
    jstate = _to_jax_state(state_to_numpy(state))
    jenv = _jax_env(task, nb)
    np.testing.assert_allclose(env.core.rest_pose, jenv.rest_pose, atol=1e-5)
    decode = jax.jit(jax.vmap(jenv.step_decode_pre))
    finish = jax.jit(jax.vmap(jenv.step_finish))
    rest = jnp.asarray(jenv.rest_pose)
    xla = _xla(nb, CHEST_DOOR[task])
    size = N_STATE * len(KINDS)

    def run(phys, ctl, n_sub):
        """The XLA engine at the batch it was compiled for by the stress
        check (`_all_states`), the main path's envs tiled into it: one
        compile per scene, not one per batch size."""
        reps = -(-size // N_ENVS)
        out = xla(*(jax.tree_util.tree_map(
            lambda x: jnp.concatenate([x] * reps)[:size], tree)
            for tree in (phys, ctl)), n_sub)
        return jax.tree_util.tree_map(lambda x: x[:N_ENVS], out)

    rng = np.random.default_rng(0)
    actions = rng.uniform(-1, 1, (N_STEPS, N_ENVS, env.cfg.action_dim)
                          ).astype(np.float32)
    door_t = jnp.full((N_ENVS,), opened, jnp.float32)
    for i, a in enumerate(actions):
        jstate, f_t = decode(jstate, jnp.asarray(a))
        q_t = _solve(jstate.ee_target, jstate.phys.q, rest)
        phys = run(jstate.phys, JD.Controls(
            q_target=q_t, f_target=f_t, door_motor_on=jstate.door_hold_open,
            door_target=door_t), 100)
        jstate = jstate._replace(phys=phys, steps=jstate.steps + 1)
        jstate, jobs, jrew, _ = finish(jstate)
        state, obs, reward, done, _ = env.step(state, t(a))
        for k in ('observation', 'policy_state', 'achieved_goal',
                  'desired_goal'):
            np.testing.assert_allclose(n(obs[k]), np.asarray(jobs[k]),
                                       atol=5e-3, err_msg=k)
        d = np.linalg.norm(np.asarray(jobs['achieved_goal'])
                           - np.asarray(jobs['desired_goal']), axis=-1)
        sure = np.abs(d - env.cfg.distance_threshold) >= 5e-3
        np.testing.assert_array_equal(n(reward)[sure], np.asarray(jrew)[sure])
        door_q = np.asarray(jstate.phys.door_q)
        sure = np.abs(np.abs(opened - door_q) - 0.01) >= 5e-3
        np.testing.assert_array_equal(n(state.door_hold_open)[sure],
                                      np.asarray(jstate.door_hold_open)[sure])
        if i == 0:
            np.testing.assert_array_equal(n(state.door_hold_open), n(near))
        assert not n(done).any()
    # the door first in the goals; the latched doors held near open
    assert (n(obs['desired_goal'])[:, 0] == np.float32(opened)).all()
    np.testing.assert_array_equal(n(obs['achieved_goal'])[:, 0],
                                  n(state.phys.door_q))
    assert (n(state.phys.door_q)[n(near)] > opened - 0.01).all()
    assert env.core.ik.launches == 0 and env.core.engine.launches == 0


# -------------------------------------------------- deterministic parts
def _jax_chest(task, nb, **kw):
    """The JAX env's goal, sub-goal and keypoint methods on a stand-in that
    holds only what they read."""
    cfg = JaxConfig(task=task, num_block=nb, **kw)
    eng = JD.Engine(JS.multi_step_scene(nb, True, cfg.chest_door))
    cb = np.asarray(eng.chest_base, np.float32)
    j = types.SimpleNamespace(
        cfg=cfg, nb=nb, engine=eng,
        chest_center=np.array([cb[0] + 0.05, cb[1], 0.175], np.float32),
        chest_top=np.array([cb[0] + 0.05, cb[1], 0.3], np.float32))
    for name in ('_goal_chest', '_chest_subgoals', '_keypoint_state'):
        setattr(j, name, functools.partial(getattr(jms.KukaMultiBlockEnv,
                                                   name), j))
    return j


@pytest.mark.parametrize('task', ['chest_push', 'chest_pick_and_place'])
@pytest.mark.parametrize('grip_informed', [False, True])
@pytest.mark.parametrize('curriculum', [False, True])
def test_goal_chest_matches_jax(task, grip_informed, curriculum):
    """`_goal_chest` on one port reset state with 3 blocks, from given
    curriculum levels and block masks (level 0 reads the gripper), and with
    task decomposition its sub-goals (`_chest_subgoals`): the door first,
    then the blocks, then the gripper entries; 1e-6."""
    nb, count = 3, 6
    kw = dict(grip_informed_goal=grip_informed, use_curriculum=curriculum,
              task_decomposition=not curriculum)
    env = make_vec_env(num_envs=count, task=task, num_block=nb,
                       device='cpu', seed=3, **kw)
    state, _ = env.reset()
    rng = np.random.default_rng(5)
    level = np.array([0, 1, 2, 3, 0, 2], np.int32)
    mask = rng.random((count, nb)) < 0.5
    state = state._replace(curriculum_level=t(level).to(torch.int32),
                           ind_block_to_move=torch.as_tensor(mask))
    grip = t(rng.uniform(-0.6, -0.4, (count, 3)))
    close = t(rng.uniform(0.0, 0.07, (count, 1)))
    pick = task == 'chest_pick_and_place'
    door_open = 0.10 if pick else 0.12
    blocks = state.phys.body_pos
    got = env.core._goal_chest(state, blocks, False, None, grip, close,
                               door_open, pick)
    j = _jax_chest(task, nb, **kw)
    jstate = _to_jax_state(state_to_numpy(state))
    want = jax.vmap(lambda s, b, g, c: j._goal_chest(
        s, b, False, None, g, c, door_open, pick))(
            jstate, *(jnp.asarray(n(x)) for x in (blocks, grip, close)))
    np.testing.assert_allclose(n(got.desired_goal),
                               np.asarray(want.desired_goal), atol=1e-6)
    # the JAX env's own `goal_dim` on the stand-in's config (building the
    # JAX env itself would solve its rest pose, 5 s, for nothing here)
    assert got.desired_goal.shape[1] == env.core.goal_dim == \
        jms.KukaMultiBlockEnv.goal_dim.fget(j)
    if not curriculum:
        np.testing.assert_allclose(n(got.sub_goals), np.asarray(
            want.sub_goals), atol=1e-6)
        assert got.sub_goals.shape[1] == env.cfg.num_steps


@pytest.mark.parametrize('task', ['chest_push', 'chest_pick_and_place'])
def test_num_steps_and_goal_dim_match_jax(task):
    """The sub-goal count and the goal's size, 1-5 blocks, with and
    without the gripper entries."""
    for nb in range(1, 6):
        for grip in (False, True):
            kw = dict(task=task, num_block=nb, grip_informed_goal=grip)
            jcfg = JaxConfig(**kw)
            assert EnvConfig(**kw).num_steps == jcfg.num_steps
            assert EnvConfig(**kw).num_curriculum == nb + 1
            gd = 3 * nb + 1 + ((4 if jcfg.grasping else 3) if grip else 0)
            env = make_vec_env(num_envs=1, device='cpu', **kw)
            assert env.core.goal_dim == gd


@pytest.mark.parametrize('task', ['chest_push', 'chest_pick_and_place'])
def test_keypoint_state_matches_jax(task):
    """The door's three keypoints, each position and velocity, over the
    door's range: 1e-6."""
    env = make_vec_env(num_envs=1, task=task, num_block=1, device='cpu')
    j = _jax_chest(task, 1)
    rng = np.random.default_rng(1)
    q = rng.uniform(0.0, env.core.scene.door_limit, 16).astype(np.float32)
    qd = rng.uniform(-0.3, 0.3, 16).astype(np.float32)
    got = env.core._keypoint_state(t(q), t(qd))
    want = jax.vmap(j._keypoint_state)(jnp.asarray(q), jnp.asarray(qd))
    assert got.shape == (16, 18)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize('task', ['chest_push', 'chest_pick_and_place'])
def test_reset_invariants(task):
    """The chest's spawn bounds (x shifted +0.05, y widened by 0.05 each
    way), the door closed and unlatched, the observation layout, and under
    the curriculum ``level`` blocks moved into the chest; the TimeLimit's
    reset clears the latch."""
    count, nb = 256, 3
    env = make_vec_env(num_envs=count, task=task, num_block=nb, device='cpu',
                       seed=3, use_curriculum=True)
    core = env.core
    state, obs = env.reset()
    blocks = n(state.phys.body_pos)
    lower = core.tip_initial - 0.1 + np.array([0.08, -0.05, 0.0])
    upper = core.tip_initial + 0.1 + np.array([0.02, 0.05, 0.0])
    np.testing.assert_allclose(core.object_lower[:2], lower[:2], atol=1e-12)
    np.testing.assert_allclose(core.object_upper[:2], upper[:2], atol=1e-12)
    assert (blocks[..., :2] >= lower[:2] - 1e-6).all()
    assert (blocks[..., :2] <= upper[:2] + 1e-6).all()
    assert (n(state.phys.door_q) == 0).all()
    assert not n(state.door_hold_open).any()
    dims = {'observation': 8 + 16 * nb + 20, 'policy_state': 4 + 3 * nb + 19,
            'achieved_goal': 3 * nb + 1, 'desired_goal': 3 * nb + 1}
    assert {k: tuple(v.shape) for k, v in obs.items()} == {
        k: (count, d) for k, d in dims.items()}
    assert (n(state.curriculum_level) == 0).all()
    # a latched batch with every curriculum level equally likely, through
    # the TimeLimit's reset
    latched = state._replace(
        door_hold_open=torch.ones_like(state.door_hold_open),
        curriculum_prob=torch.full_like(state.curriculum_prob, 1 / (nb + 1)))
    state, obs = env._auto_reset(latched)
    assert not n(state.door_hold_open).any()
    blocks = n(state.phys.body_pos)
    level = n(state.curriculum_level)
    assert ((level >= 0) & (level <= nb)).all() and (level == nb).any()
    moved = n(state.ind_block_to_move)
    assert (moved.sum(1) == level).all()
    goal = n(obs['desired_goal'])[:, 1:].reshape(count, nb, 3)
    np.testing.assert_array_equal(goal[moved], np.broadcast_to(
        core.chest_center, goal[moved].shape))
    np.testing.assert_array_equal(goal[~moved], blocks[~moved])
    assert (n(obs['desired_goal'])[:, 0]
            == np.float32(env.cfg.chest_door_opened_state)).all()


@pytest.mark.parametrize('task', ['chest_push', 'chest_pick_and_place'])
@pytest.mark.parametrize('joint_control', [False, True])
def test_resets_and_steps(task, joint_control):
    """Each chest env resets at 1-5 blocks and steps at 1 and 2 on the CPU,
    under EE and joint control: the JAX package's observation sizes (its
    reset at 1 block, the layout for more), finite values, the door closed
    and unlatched at reset, and the plain kernels only."""
    joint = 7 if joint_control else 0
    for nb in range(1, 6):
        env = make_vec_env(num_envs=2, task=task, num_block=nb,
                           joint_control=joint_control, device='cpu', seed=nb)
        state, obs = env.reset()
        dims = {'observation': (joint + 28 + 16 * nb,),
                'policy_state': (joint + 23 + 3 * nb,),
                'achieved_goal': (1 + 3 * nb,), 'desired_goal': (1 + 3 * nb,)}
        assert {k: v.shape[1:] for k, v in obs.items()} == dims
        if nb == 1:
            # the JAX reset's observation shapes, traced without running it
            jobs = jax.eval_shape(
                _jax_env(task, nb, joint_control=joint_control).reset,
                jax.random.PRNGKey(0))[1]
            assert {k: v.shape for k, v in jobs.items()} == dims
        assert not n(state.door_hold_open).any()
        assert (n(state.phys.door_q) == 0).all()
        if nb > 2:
            continue
        rng = np.random.default_rng(nb)
        state, obs, reward, done, _ = env.step(state, t(rng.uniform(
            -1, 1, (2, env.cfg.action_dim))))
        for k, v in obs.items():
            assert np.isfinite(n(v)).all(), k
        assert n(state.phys.door_q).min() >= 0.0
        assert env.core.engine.launches == 0
