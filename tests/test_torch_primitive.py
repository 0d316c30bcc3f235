"""The port's push-primitive slice against the JAX package, on the CPU:
kernel K3's plain version (`ops/multibody_plain.py`) on the scenes of
bodies of several box geoms and sizes, and the primitive_push_assemble and
primitive_push_reach envs (`envs/shape_assemble.py`).

The JAX side of the physics is the XLA engine (`ops/dynamics.py:Engine`,
whose contact plan uses the same manifolds as the Pallas kernel K3), compiled
once per scene as one vmapped loop of substeps with a traced trip count. The
port follows the JAX package's batched primitive (`execute_primitive_batched`,
the path its vec env runs), whose IK takes 16 iterations, so the reference
composition is `ik.solve(num_iters=16)` then 80 substeps
(`Engine.control_step(n_sim_calls=4)`) per sub-target of
`_interp_waypoints`. Both sides start from the same state, carried across in
the path-keyed checkpoint format (`interop.py`). Torch's RNG cannot
reproduce JAX keys, so resets are checked by their invariants.

Tolerances: the state 2e-3 after 2 and 80 substeps (the bound the JAX
package holds its Pallas engines to against its XLA engine), IK 1e-4 rad,
observations 5e-3, waypoints and goals 1e-5.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pybullet_multigoal_gym_tpu  # noqa: F401  (JAX precision config)
from pybullet_multigoal_gym_tpu.config import EnvConfig as JaxConfig
from pybullet_multigoal_gym_tpu.envs import shape_assemble as jsa
from pybullet_multigoal_gym_tpu.ops import dynamics as JD
from pybullet_multigoal_gym_tpu.ops import ik as jik
from pybullet_multigoal_gym_tpu.ops import pallas_multibody as PM
from pybullet_multigoal_gym_tpu.ops import scene as JS
from pybullet_multigoal_gym_tpu.utils import checkpoint
from pybullet_multigoal_gym_tpu_torch import make_vec_env
from pybullet_multigoal_gym_tpu_torch.envs import shape_assemble as sa
from pybullet_multigoal_gym_tpu_torch.interop import (state_from_numpy,
                                                      state_to_numpy)
from pybullet_multigoal_gym_tpu_torch.maths import quat as tq
from pybullet_multigoal_gym_tpu_torch.ops import dynamics as D
from pybullet_multigoal_gym_tpu_torch.ops import engine_plain as EP
from pybullet_multigoal_gym_tpu_torch.ops import ik
from pybullet_multigoal_gym_tpu_torch.ops import multibody_plain as MP
from pybullet_multigoal_gym_tpu_torch.ops import scene as S
from tests.test_torch_multibody import _jax_tree, _to_jax_state
from tests.torch_common import (ARM_FIELDS, BODY_FIELDS, n, plain_run,
                                primitive_inputs, primitive_rest, t,
                                torch_controls, torch_state)

torch.set_num_threads(1)

KEYS = {'primitive_push_assemble': ('slot', 'cube'),
        'primitive_push_reach': ('rectangle',)}
# envs per JAX program (the XLA engine's and the IK's are compiled for it)
N_ENVS = 2


# ------------------------------------------------------------ the plan
@pytest.mark.parametrize('keys', [('slot', 'cube'), ('rectangle',)])
@pytest.mark.parametrize('joint_control', [False, True])
def test_lane_plan_matches_pallas_count(keys, joint_control):
    """The plain version's lanes are the Pallas kernel's (159 / 161 for the
    slot and cube, 42 / 44 for the rectangle), in its order: per geom the
    plane and the fingers, the geom pairs of the two bodies, the finger
    pads, the spheres; every lane of a geom acts on its body."""
    spec = S.shape_assemble_scene(keys)
    sc = D.multibody_consts(spec, ik_workspace=not joint_control)
    plan = MP.lane_plan(sc)
    assert len(plan) == PM.count_lanes(JS.shape_assemble_scene(keys),
                                       ik_workspace=not joint_control)
    groups = [MP.lane_group(l) for l in plan]
    head = (['box-plane'] * 4 + ['finger-box'] * 18) * sc.ng
    head += ['box-box'] * (10 * len(sc.geom_pairs)) + ['finger-plane'] * 8
    assert groups[:len(head)] == head
    assert set(groups[len(head):]) == {'sphere-plane', 'sphere-box'}
    bodies = [l.side_a[1] for l in plan[:22 * sc.ng]]
    assert bodies == [b for b in sc.geom_body for _ in range(22)]
    st = torch_state(primitive_inputs(keys, 'drop', 2)[0])
    lanes = MP.build_lanes(sc, EP.fk_chain(st.q, st.fq), st.body_pos,
                           st.body_quat, tq.to_matrix(st.body_quat))
    assert all(x.shape[1] == len(plan) for x in lanes)


# ---------------------------------------------- the JAX reference, once
@functools.lru_cache(maxsize=None)
def _jenv(task):
    """The JAX package's primitive env (its rest pose, goals, observation),
    built once per task."""
    return jsa.KukaPrimitiveEnv(JaxConfig(task=task,
                                          primitive='discrete_push'))


@functools.lru_cache(maxsize=None)
def _xla(task):
    """The task's XLA engine compiled once: ``run(state, controls,
    n_substeps)`` over a batch (a traced trip count)."""
    eng = JD.Engine(JS.shape_assemble_scene(KEYS[task]), ik_workspace=True)
    return jax.jit(jax.vmap(
        lambda s, c, k: jax.lax.fori_loop(0, k,
                                          lambda i, x: eng.substep(x, c), s),
        in_axes=(0, 0, None)))


# the primitive's IK (`PallasIK(num_iters=16)`'s math), one program for
# every rest pose
_ik16_batch = jax.jit(jax.vmap(lambda tgt, q, rest: jik.solve(
    tgt, q_init=q, rest_pose=rest, num_iters=16), in_axes=(0, 0, None)))


def _ik16(tgt, q, rest):
    """`_ik16_batch` in batches of N_ENVS (one compiled program)."""
    return jnp.concatenate([_ik16_batch(tgt[i:i + N_ENVS], q[i:i + N_ENVS],
                                        rest)
                            for i in range(0, tgt.shape[0], N_ENVS)])


def _hold(out, ref, tol=2e-3):
    for f in ARM_FIELDS + BODY_FIELDS:
        np.testing.assert_allclose(n(getattr(out, f)), n(getattr(ref, f)),
                                   atol=tol, err_msg=f)
    np.testing.assert_allclose(n(out.ee_contact_force),
                               n(ref.ee_contact_force), atol=tol / D.DT_SUB)


# -------------------------------------------------- against the XLA engine
@pytest.mark.parametrize('task', list(KEYS))
def test_control_step_plain_matches_xla(task):
    """The objects dropped onto the plate, turned and tilted, after 2 and
    after 80 substeps (one sub-target's worth)."""
    keys = KEYS[task]
    st, ctl = primitive_inputs(keys, 'drop', N_ENVS, seed=4)
    sc = D.multibody_consts(S.shape_assemble_scene(keys))
    jst, jctl = _jax_tree(JD.PhysicsState, st), _jax_tree(JD.Controls, ctl)
    out = MP.control_step(sc, torch_state(st), torch_controls(ctl), 2)
    _hold(out, _xla(task)(jst, jctl, 2))
    out = MP.control_step(sc, out, torch_controls(ctl), 78)
    _hold(out, _xla(task)(jst, jctl, 80))
    # the objects came to rest on the plate
    assert np.abs(n(out.body_pos)[..., 2] - 0.035).max() < 2e-3


def test_ik_16_iterations_matches_jax():
    """K1's plain version at the primitive's 16 iterations on primitive
    sub-targets (every sub-target of 4 discrete pushes, warm-started from
    around the rest pose) against `ik.solve(num_iters=16)`."""
    env = make_vec_env(num_envs=4, task='primitive_push_assemble',
                       primitive='discrete_push', device='cpu')
    rng = np.random.default_rng(5)
    a = np.stack([rng.integers(0, k, 4) for k in env.action_space.nvec], -1)
    sub = env.core._interp_waypoints(
        env.core.step_decode_waypoints(t(a))).reshape(-1, 3)
    rest = primitive_rest()
    q0 = rest + rng.uniform(-0.2, 0.2, (sub.shape[0], 7)).astype(np.float32)
    got = ik.solve(sub, q_init=t(q0), rest_pose=t(rest).expand(len(q0), 7),
                   num_iters=sa.PRIMITIVE_IK_ITERS)
    want = _ik16(jnp.asarray(n(sub)), jnp.asarray(q0), jnp.asarray(rest))
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-4)
    assert env.core.ik.num_iters == 16


# -------------------------------------------------- the env's pieces
def _actions(env, rng, count):
    if env.cfg.primitive == 'discrete_push':
        return np.stack([rng.integers(0, k, count)
                         for k in env.action_space.nvec], -1).astype(
                             np.float32)
    # past [-1, 1] too: the decode clamps
    return rng.uniform(-1.2, 1.2, (count, 3)).astype(np.float32)


@pytest.mark.parametrize('task,primitive', [
    ('primitive_push_assemble', 'discrete_push'),
    ('primitive_push_reach', 'continuous_push'),
    ('primitive_push_assemble', 'continuous_push'),
    ('primitive_push_reach', 'discrete_push')])
def test_env_pieces_match_jax(task, primitive):
    """`step_decode_waypoints`, `_interp_waypoints`, `_generate_goal` and
    `step_finish` (observation, reward, achieved goal) on one port reset
    state whose objects were then moved, against the JAX package's."""
    count = 8
    env = make_vec_env(num_envs=count, task=task, primitive=primitive,
                       device='cpu', seed=1)
    state, _ = env.reset()
    # the JAX env of the other primitive differs only in its config
    jenv = copy.copy(_jenv(task))
    jenv.cfg = JaxConfig(task=task, primitive=primitive)
    np.testing.assert_allclose(env.core.rest_pose, jenv.rest_pose, atol=1e-5)
    assert env.core.action_map_width == jenv.action_map_width == 224
    assert env.core.action_map_height == jenv.action_map_height == 224
    rng = np.random.default_rng(2)
    a = _actions(env, rng, count)
    jstate = _to_jax_state(state_to_numpy(state))
    wps = env.core.step_decode_waypoints(t(a))
    jwps = jax.vmap(jenv.step_decode_waypoints)(jstate, jnp.asarray(a))
    np.testing.assert_allclose(n(wps), np.asarray(jwps), atol=1e-5)
    np.testing.assert_allclose(n(env.core._interp_waypoints(wps)),
                               np.asarray(jenv._interp_waypoints(jwps)),
                               atol=1e-5)
    # the objects pushed and turned: the goal (assemble: the slot's frame)
    # and the observation follow them
    ph = state.phys
    moved = ph._replace(
        body_pos=ph.body_pos + t(rng.uniform(-0.05, 0.05, ph.body_pos.shape)),
        body_quat=tq.mul(tq.yaw_quat_zyz(t(rng.uniform(
            -3, 3, ph.body_pos.shape[:2]))), ph.body_quat))
    state = state._replace(phys=moved, steps=state.steps + 1)
    jstate = _to_jax_state(state_to_numpy(state))
    if task == 'primitive_push_assemble':
        got = env.core._generate_goal(state, None).desired_goal
        want = jax.vmap(jenv._generate_goal)(jstate, jstate.key).desired_goal
        np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5)
    _, obs, reward, achieved = env.core.step_finish(state)
    _, jobs, jrew, jach = jax.vmap(jenv.step_finish)(jstate)
    for k in ('observation', 'policy_state', 'achieved_goal',
              'desired_goal'):
        np.testing.assert_allclose(n(obs[k]), np.asarray(jobs[k]), atol=5e-3,
                                   err_msg=k)
    d = np.linalg.norm(np.asarray(jobs['achieved_goal'])
                       - np.asarray(jobs['desired_goal']), axis=-1)
    sure = np.abs(d - env.cfg.distance_threshold) >= 5e-3
    np.testing.assert_array_equal(n(reward)[sure], np.asarray(jrew)[sure])
    np.testing.assert_array_equal(n(achieved)[sure], np.asarray(jach)[sure])


def _jax_subtargets(jenv, run, jphys, sub, count):
    """The JAX composition of a primitive over sub-targets ``sub`` (count,
    K, 3): per sub-target the 16-iteration IK, then 80 substeps with the
    fingers at their limit."""
    rest = jnp.asarray(jenv.rest_pose)
    zeros = jnp.zeros((count,), jnp.float32)
    f_open = jnp.full((count, 2), jenv.gripper_abs_joint_limit, jnp.float32)
    q_ts = []
    for w in range(sub.shape[1]):
        q_t = _ik16(jnp.asarray(sub[:, w]), jphys.q, rest)
        q_ts.append(q_t)
        jphys = run(jphys, JD.Controls(q_target=q_t, f_target=f_open,
                                       door_motor_on=zeros > 0,
                                       door_target=zeros),
                    sa.SUBSTEPS_PER_TARGET)
    return jphys, q_ts


def test_primitive_subtarget_matches_jax():
    """One sub-target of the primitive (K1 at 16 iterations from the
    current configuration, then 80 substeps with the fingers held) on the
    'press' state: the pads push the cube into the slot's mouth, so
    finger-box and box-box lanes of the slot's side geoms act."""
    task = 'primitive_push_assemble'
    env = make_vec_env(num_envs=N_ENVS, task=task,
                       primitive='discrete_push', device='cpu')
    st, _ = primitive_inputs(KEYS[task], 'press', N_ENVS, seed=6)
    phys = torch_state(st)
    # the tip 7.5 mm behind the cube's centre, at the push height
    sub = (n(phys.body_pos[:, 1]) + np.array([-0.0075, 0.0, 0.015],
                                              np.float32))[:, None]
    core = env.core
    q_t = core.ik.solve(t(sub[:, 0]), q_init=phys.q,
                        rest_pose=core._rest.expand(N_ENVS, 7))
    ctl = D.Controls(q_target=q_t,
                     f_target=torch.full((N_ENVS, 2), 0.035),
                     door_motor_on=torch.zeros(N_ENVS, dtype=torch.bool),
                     door_target=torch.zeros(N_ENVS))
    # the wrapper's CPU path is this plain run (which also notes the lanes
    # that act)
    out, active = plain_run(core.scene, phys, ctl, sa.SUBSTEPS_PER_TARGET)
    ref, (jq_t,) = _jax_subtargets(_jenv(task), _xla(task),
                                   _jax_tree(JD.PhysicsState, st), sub,
                                   N_ENVS)
    np.testing.assert_allclose(n(q_t), np.asarray(jq_t), atol=1e-4)
    _hold(out, ref)
    assert active['finger-box'] == 1.0 and active['box-box'] == 1.0, active
    # the cube (geom 3) against the slot's prongs (geoms 1 and 2)
    assert active['box-box 1-3'] > 0 and active['box-box 2-3'] > 0, active
    # the pads pushed the cube in
    assert (n(out.body_pos - phys.body_pos)[:, 1, 0] > 1e-3).all()


@pytest.mark.slow
def test_primitive_step_matches_jax():
    """One whole primitive step (20 sub-targets, 1600 plain substeps) at 1
    env, a push aimed through the cube, against the JAX composition and
    `step_finish`."""
    task = 'primitive_push_assemble'
    env = make_vec_env(num_envs=1, task=task, primitive='discrete_push',
                       device='cpu', seed=3)
    state, _ = env.reset()
    cube = n(state.phys.body_pos[0, 1])
    lower = sa.WORKSPACE_LOWER_XY
    # angle index 0 pushes toward +x, from 5 cm behind the cube
    a = np.array([[0.0, round((cube[0] - 0.05 - lower[0]) / sa.RESOLUTION),
                   round((cube[1] - lower[1]) / sa.RESOLUTION)]], np.float32)
    jenv = _jenv(task)
    jstate = _to_jax_state(state_to_numpy(state))
    state, obs, _, _, _ = env.step(state, t(a))
    wps = jax.vmap(jenv.step_decode_waypoints)(jstate, jnp.asarray(a))
    rest = jnp.asarray(jenv.rest_pose)[None]
    jphys = jstate.phys._replace(q=rest, qd=jnp.zeros((1, 7), jnp.float32))
    jphys, _ = _jax_subtargets(jenv, _xla(task), jphys,
                               np.asarray(jenv._interp_waypoints(wps)), 1)
    jphys = jphys._replace(q=rest, qd=jnp.zeros((1, 7), jnp.float32))
    jstate = jstate._replace(phys=jphys, steps=jstate.steps + 1)
    _, jobs, _, _ = jax.vmap(jenv.step_finish)(jstate)
    for k in ('observation', 'achieved_goal', 'desired_goal'):
        np.testing.assert_allclose(n(obs[k]), np.asarray(jobs[k]), atol=5e-3,
                                   err_msg=k)
    # the push moved the cube
    assert np.abs(n(obs['observation'])[0, 6:8] - cube[:2]).max() > 0.01


# -------------------------------------------- resets, actions, state
@pytest.mark.parametrize('task', list(KEYS))
def test_reset_invariants(task):
    count = 256
    env = make_vec_env(num_envs=count, task=task,
                       primitive='continuous_push', device='cpu', seed=3)
    core = env.core
    state, obs = env.reset()
    nb = len(KEYS[task])
    dims = {'observation': 6 * nb, 'policy_state': 6 * nb,
            'achieved_goal': 6, 'desired_goal': 6}
    assert {k: tuple(v.shape) for k, v in obs.items()} == {
        k: (count, d) for k, d in dims.items()}
    pos, quat = n(state.phys.body_pos), n(state.phys.body_quat)
    # objects: apart, away from the gripper start, in bounds, on the plate,
    # each turned about z alone by a yaw in [-pi, pi]
    if nb > 1:
        assert (np.linalg.norm(pos[:, 0, :2] - pos[:, 1, :2], axis=-1)
                > 0.06).all()
    assert (np.linalg.norm(pos[..., :2] - core.tip_initial[:2], axis=-1)
            > 0.06).all()
    assert (pos[..., :2] >= core.object_lower[:2] - 1e-6).all()
    assert (pos[..., :2] <= core.object_upper[:2] + 1e-6).all()
    np.testing.assert_allclose(pos[..., 2], 0.035, atol=1e-7)
    np.testing.assert_allclose(quat[..., 1:3], 0.0, atol=1e-7)
    yaw = 2 * np.arctan2(quat[..., 3], quat[..., 0])
    assert (np.abs(yaw) <= np.pi + 1e-5).all() and yaw.std() > 1.0
    goal = n(state.desired_goal)
    if task == 'primitive_push_assemble':
        c, s = np.cos(yaw[:, 0]), np.sin(yaw[:, 0])
        slot_target = pos[:, 0, :2] - 0.03 * np.stack([c, s], -1)
        np.testing.assert_allclose(goal[:, :2], slot_target, atol=1e-6)
    else:
        assert (goal[:, :2] >= core.target_lower[:2] - 1e-6).all()
        assert (goal[:, :2] <= core.target_upper[:2] + 1e-6).all()
        np.testing.assert_allclose(goal[:, 2], 0.035, atol=1e-7)
        # the goal is the first of 24 draws in the target box more than
        # 0.06 m from the object, judged before its height is set
        gen = torch.Generator().manual_seed(11)
        again = core._generate_goal(state, gen).desired_goal
        gen.manual_seed(11)
        u = n(torch.rand((count, 24, 3), generator=gen))
        cands = core.target_lower + (core.target_upper - core.target_lower) * u
        ok = np.linalg.norm(cands - pos[:, :1], axis=-1) > 0.06
        first = cands[np.arange(count), ok.argmax(1)]
        assert ok.any(1).all()
        np.testing.assert_allclose(n(again)[:, :2], first[:, :2], atol=1e-6)
    # a reseeded reset repeats itself
    again, _ = env.reset(seed=3)
    np.testing.assert_array_equal(n(again.desired_goal), goal)


def test_discrete_actions_stay_in_the_workspace():
    """`MultiDiscrete((20, 224, 224))`: every corner and middle of the
    action map decodes into waypoints inside the push workspace, at the
    primitive's two heights."""
    env = make_vec_env(num_envs=1, task='primitive_push_reach',
                       primitive='discrete_push', device='cpu')
    space = env.action_space
    assert space.nvec == (20, 224, 224)
    grid = np.array([[k, x, y] for k in (0, 7, 19) for x in (0, 111, 223)
                     for y in (0, 111, 223)], np.float32)
    assert all(space.contains(a.astype(int)) for a in grid)
    assert not space.contains(np.array([20, 0, 0]))
    wps = n(env.core.step_decode_waypoints(t(grid)))
    lo, hi = sa.WORKSPACE_LOWER_XY, sa.WORKSPACE_UPPER_XY
    assert (wps[..., :2] >= lo - 1e-6).all()
    assert (wps[..., :2] <= hi + 1e-6).all()
    np.testing.assert_allclose(np.unique(wps[..., 2]), [0.05, 0.14], atol=1e-6)


@pytest.mark.parametrize('task', list(KEYS))
def test_state_round_trips_through_interop(task, tmp_path):
    """A port reset state goes to the JAX package's checkpoint format and
    back unchanged, and the JAX observation of it is the port's."""
    env = make_vec_env(num_envs=4, task=task, primitive='discrete_push',
                       device='cpu', seed=7)
    state, obs = env.reset()
    leaves = state_to_numpy(state)
    jstate = _to_jax_state(leaves)
    checkpoint.save(str(tmp_path / 'state'), jstate)
    with np.load(str(tmp_path / 'state.npz')) as f:
        back = state_from_numpy(dict(f), device='cpu')
    for k, v in state_to_numpy(back).items():
        np.testing.assert_array_equal(v, leaves[k], err_msg=k)
    jobs = jax.vmap(lambda s: _jenv(task)._get_obs(s)[0])(jstate)
    for k, v in obs.items():
        np.testing.assert_allclose(n(v), np.asarray(jobs[k]), atol=1e-6,
                                   err_msg=k)
