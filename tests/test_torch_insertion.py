"""The port's insertion slice against the JAX package, on the CPU: kernel
K3's plain version (`ops/multibody_plain.py`) on the scene of a free
rectangle and a pinned slot, K1's plain version with rotation targets,
the EE force sensor and the insertion env (`envs/insertion.py`).

The JAX side of the physics is the XLA engine (`ops/dynamics.py:Engine`,
whose contact plan uses the same one- and two-sided manifolds as the Pallas
kernel K3 for a pinned body), compiled once for the module as one vmapped
loop of substeps with a traced trip count. The port follows the JAX
package's batched step (decode, `ik.solve(num_iters=8)` toward the ZYZ
accumulator's quaternion, 100 substeps, `step_finish`), which its vec env
runs; its per-env XLA `step` solves IK at the model's default 40
iterations. Both sides start from the same state, carried across in the
path-keyed checkpoint format (`interop.py`). Torch's RNG cannot reproduce
JAX keys, so resets and the state noise are checked by their invariants.

ZYZ Euler angles of an upright object are singular (beta 0: only alpha +
gamma is defined), so a last-bit tilt can turn alpha and gamma by up to 2
pi. Observations are compared on one shared state, where both packages
compute them from the same bits; after a step, rotations are compared as
quaternions.

Tolerances: the one-sided lane geometry 1e-6; the state 2e-3 after 2 and
100 substeps (the bound the JAX package holds its Pallas engines to
against its XLA engine; the EE force as its impulse, force x dt); IK 1e-4
rad; the EE force sensor 1e-4 N (the two packages' link-7 rotations
differ by up to 2.4e-7, which turns a force of up to 150 N by about that);
observations, goals and rewards 5e-3, done flags equal where the distance
is 5e-3 or more from the threshold.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pybullet_multigoal_gym_tpu  # noqa: F401  (JAX precision config)
from pybullet_multigoal_gym_tpu.config import EnvConfig as JaxConfig
from pybullet_multigoal_gym_tpu.envs import insertion as jins
from pybullet_multigoal_gym_tpu.envs import robot as jrobot
from pybullet_multigoal_gym_tpu.maths import quat as jq
from pybullet_multigoal_gym_tpu.ops import dynamics as JD
from pybullet_multigoal_gym_tpu.ops import ik as jik
from pybullet_multigoal_gym_tpu.ops import pallas_engine as PE
from pybullet_multigoal_gym_tpu.ops import pallas_multibody as PM
from pybullet_multigoal_gym_tpu.ops import scene as JS
from pybullet_multigoal_gym_tpu_torch import make_vec_env
from pybullet_multigoal_gym_tpu_torch.envs import insertion as ins
from pybullet_multigoal_gym_tpu_torch.envs import robot
from pybullet_multigoal_gym_tpu_torch.interop import (state_from_numpy,
                                                      state_to_numpy)
from pybullet_multigoal_gym_tpu_torch.maths import quat as tq
from pybullet_multigoal_gym_tpu_torch.model import kuka_model as KM
from pybullet_multigoal_gym_tpu_torch.ops import dynamics as D
from pybullet_multigoal_gym_tpu_torch.ops import engine_plain as EP
from pybullet_multigoal_gym_tpu_torch.ops import ik
from pybullet_multigoal_gym_tpu_torch.ops import multibody_plain as MP
from pybullet_multigoal_gym_tpu_torch.ops import scene as S
from tests.test_torch_multibody import _jax_tree, _to_jax_state
from tests.torch_common import (ARM_FIELDS, BODY_FIELDS, insertion_inputs, n,
                                plain_run, primitive_rest, t, torch_controls,
                                torch_state)

torch.set_num_threads(1)

# envs per JAX program (the XLA engine and the IK are compiled for it)
N_ENVS = 2
TILE = 1024


# ------------------------------------------------------ one-sided lanes
def test_one_sided_lanes_match_pallas():
    """A free box against an immovable one (the rectangle against a slot
    prong), turned and a little apart: the port's one-sided manifold and
    edge lane (`engine_plain.sat_box_box_lanes(one_sided=True)`,
    `edge_lane`) against `pallas_multibody._one_sided(edge=True)` on
    (8, 128) tiles."""
    rng = np.random.default_rng(0)
    ha, hb = (0.015, 0.015, 0.04), (0.015, 0.015, 0.015)
    ca = rng.uniform(-0.01, 0.01, (TILE, 3)).astype(np.float32)
    cb = (ca + rng.uniform(-0.05, 0.05, (TILE, 3))).astype(np.float32)
    q = rng.normal(size=(2, TILE, 4)).astype(np.float32)
    qa, qb = q / np.linalg.norm(q, axis=-1, keepdims=True)

    def tiles(x):
        return jnp.asarray(np.ascontiguousarray(x.T).reshape(-1, 8, 128))

    ref = PM._one_sided(tiles(ca), PE.qmat(tiles(qa)), ha, tiles(cb),
                        PE.qmat(tiles(qb)), hb, 1.0, ('body', 0), ('world',),
                        edge=True)
    args = (t(ca), tq.to_matrix(t(qa)), ha, t(cb), tq.to_matrix(t(qb)), hb,
            1.0)
    out = EP.sat_box_box_lanes(*args, one_sided=True) + EP.edge_lane(*args)
    assert len(out) == len(ref) == 6
    for got, want in zip(out, ref):
        act = np.asarray(want.active).reshape(-1)
        np.testing.assert_array_equal(n(got.active), act)
        on = act > 0           # where a lane does not act its point is moot
        for f in ('pt', 'nrm'):
            w = np.asarray(getattr(want, f)).reshape(3, -1).T
            np.testing.assert_allclose(n(getattr(got, f))[on], w[on],
                                       atol=1e-6, err_msg=f)
        np.testing.assert_allclose(n(got.pen)[on],
                                   np.asarray(want.pen).reshape(-1)[on],
                                   atol=1e-6)
    # each lane acts in some pairs and not in others
    assert all(10 < n(l.active).sum() < TILE - 10 for l in out[:4]), \
        [n(l.active).sum() for l in out]


# ------------------------------------------------------------ the plan
@pytest.mark.parametrize('joint_control', [False, True])
def test_lane_plan_matches_pallas_count(joint_control):
    """The plain version's lanes are the Pallas kernel's (166 under EE
    control, 168 under joint control), in its order: the rectangle's plane
    and fingers, 6 against each of the slot's 4 geoms, the fingers against
    each slot geom, the finger pads, the spheres; the slot is pinned, with
    inverse mass and inertia 0, as the XLA engine has it."""
    spec = S.insertion_scene()
    sc = D.multibody_consts(spec, ik_workspace=not joint_control)
    plan = MP.lane_plan(sc)
    assert len(plan) == PM.count_lanes(JS.insertion_scene(),
                                       ik_workspace=not joint_control)
    assert len(plan) == (168 if joint_control else 166)
    groups = [MP.lane_group(l) for l in plan]
    head = (['box-plane'] * 4 + ['finger-box'] * 18 + ['box-pinned'] * 24
            + ['finger-pinned'] * 72 + ['finger-plane'] * 8)
    assert groups[:len(head)] == head
    assert set(groups[len(head):]) == {'sphere-plane', 'sphere-box',
                                       'sphere-pinned'}
    assert sc.pinned == (False, True)
    eng = JD.Engine(JS.insertion_scene())
    np.testing.assert_allclose(sc.inv_mass, eng.body_inv_mass, rtol=1e-7)
    np.testing.assert_allclose(sc.inv_inertia, eng.body_inv_inertia,
                               rtol=1e-6)
    st = torch_state(insertion_inputs('drop', 2)[0])
    lanes = MP.build_lanes(sc, EP.fk_chain(st.q, st.fq), st.body_pos,
                           st.body_quat, tq.to_matrix(st.body_quat))
    assert all(x.shape[1] == len(plan) for x in lanes)


# ---------------------------------------------- the JAX reference, once
@functools.lru_cache(maxsize=None)
def _jenv():
    return jins.KukaInsertionEnv(JaxConfig(task='insertion'))


@functools.lru_cache(maxsize=None)
def _xla():
    """The XLA engine on the insertion scene, compiled once: ``run(state,
    controls, n_substeps)`` over a batch (a traced trip count)."""
    eng = JD.Engine(JS.insertion_scene(), ik_workspace=True)
    return jax.jit(jax.vmap(
        lambda s, c, k: jax.lax.fori_loop(0, k,
                                          lambda i, x: eng.substep(x, c), s),
        in_axes=(0, 0, None)))


# the in-step IK of the JAX package's batched path, with a target
# orientation, one program for every rest pose
_ik8 = jax.jit(jax.vmap(lambda tgt, quat, q, rest: jik.solve(
    tgt, target_quat=quat, q_init=q, rest_pose=rest, num_iters=8),
    in_axes=(0, 0, 0, None)))


def _hold(out, ref, tol=2e-3):
    for f in ARM_FIELDS + BODY_FIELDS:
        np.testing.assert_allclose(n(getattr(out, f)), n(getattr(ref, f)),
                                   atol=tol, err_msg=f)
    np.testing.assert_allclose(n(out.ee_contact_force) * D.DT_SUB,
                               n(ref.ee_contact_force) * D.DT_SUB, atol=tol,
                               err_msg='EE impulse')


# -------------------------------------------------- against the XLA engine
@pytest.mark.parametrize('kind,want', [
    ('drop', ('box-plane',)),
    ('load', ('box-pinned', 'finger-box', 'finger-pinned')),
    ('slot_pressed', ('box-pinned', 'box-pinned edge', 'sphere-pinned'))])
def test_control_step_plain_matches_xla(kind, want):
    """The rectangle dropped beside the slot; the JAX package's own 'load'
    state (its env 0: the rectangle on the slot's mouth, the pads on the
    prongs squeezing it); the rectangle driven into the slot's base bar
    with a wrist sphere on its end bar. After 2 and after 100 substeps;
    the lane groups ``want`` act, and the slot does not move."""
    st, ctl = insertion_inputs(kind, N_ENVS, seed=4)
    if kind == 'load':
        # the JAX package's state is env 0; the others are it turned, which
        # the state's ties make chaotic (see insertion_inputs)
        st = {k: v[[0] * N_ENVS] for k, v in st.items()}
        ctl = {k: v[[0] * N_ENVS] for k, v in ctl.items()}
    sc = D.multibody_consts(S.insertion_scene())
    jst, jctl = _jax_tree(JD.PhysicsState, st), _jax_tree(JD.Controls, ctl)
    out = MP.control_step(sc, torch_state(st), torch_controls(ctl), 2)
    _hold(out, _xla()(jst, jctl, 2))
    out, active = plain_run(sc, out, torch_controls(ctl), 98)
    _hold(out, _xla()(jst, jctl, 100))
    assert all(active[g] > 0 for g in want), active
    np.testing.assert_array_equal(n(out.body_pos)[:, 1], st['body_pos'][:, 1])
    np.testing.assert_array_equal(n(out.body_quat)[:, 1],
                                  st['body_quat'][:, 1])


def test_ik_rotation_targets_match_jax():
    """K1's plain version at 8 iterations toward rotation targets from the
    ZYZ accumulator (the downward pose turned by up to +-0.6 rad about
    each axis), warm-started near the rest pose, against
    `ik.solve(num_iters=8, target_quat=...)`."""
    count = 16
    rng = np.random.default_rng(5)
    tgt = rng.uniform([-0.62, -0.15, 0.1], [-0.42, 0.15, 0.3],
                      (count, 3)).astype(np.float32)
    rot = (ins.DOWN_ZYZ + rng.uniform(-0.6, 0.6, (count, 3))).astype(
        np.float32)
    quat = tq.euler_zyz_to_quat(t(rot))
    np.testing.assert_allclose(n(quat), np.asarray(jq.euler_zyz_to_quat(
        jnp.asarray(rot))), atol=1e-7)
    rest = primitive_rest()
    q0 = rest + rng.uniform(-0.1, 0.1, (count, 7)).astype(np.float32)
    got = ik.solve(t(tgt), target_quat=quat, q_init=t(q0),
                   rest_pose=t(rest).expand(count, 7), num_iters=8)
    quat = n(quat)
    want = jnp.concatenate([
        _ik8(jnp.asarray(tgt[i:i + N_ENVS]), jnp.asarray(quat[i:i + N_ENVS]),
             jnp.asarray(q0[i:i + N_ENVS]), jnp.asarray(rest))
        for i in range(0, count, N_ENVS)])
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-4)


def test_ee_joint_force_matches_jax():
    """`robot_state`'s EE force sensor: the contact force plus the
    subtree's gravity load in link 7's frame, clipped to +-50 N, on arm
    configurations around the rest pose and contact forces up to 80 N."""
    rng = np.random.default_rng(6)
    count = 64
    q = (np.asarray(KM.KUKA_REST_POSE, np.float32)
         + rng.uniform(-1.0, 1.0, (count, 7))).astype(np.float32)
    fq = rng.uniform(-0.035, 0.035, (count, 2)).astype(np.float32)
    force = rng.uniform(-80, 80, (count, 3)).astype(np.float32)
    z7, z2 = np.zeros((count, 7), np.float32), np.zeros((count, 2),
                                                        np.float32)
    got = robot.robot_state(t(q), t(z7), t(fq), t(z2), True,
                            ee_contact_force=t(force))['ee_joint_force']
    want = jax.vmap(lambda *a: jrobot.robot_state(
        *a[:4], grasping=True, ee_contact_force=a[4])['ee_joint_force'])(
        *(jnp.asarray(x) for x in (q, z7, fq, z2, force)))
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-4)
    assert (np.abs(n(got)) == 50.0).any() and (np.abs(n(got)) < 50.0).any()


# -------------------------------------------------- the env's pieces
def test_reset_invariants():
    count = 256
    env = make_vec_env(num_envs=count, task='insertion', device='cpu',
                       seed=3)
    core = env.core
    state, obs = env.reset()
    dims = {'observation': 24, 'policy_state': 17, 'auxiliary_task_state': 12,
            'achieved_goal': 6, 'desired_goal': 6}
    assert {k: tuple(v.shape) for k, v in obs.items()
            if k != 'subtask_rewards'} == {k: (count, d)
                                           for k, d in dims.items()}
    assert env.action_space.shape == (7,)
    pos, quat = n(state.phys.body_pos), n(state.phys.body_quat)
    # the rectangle (body 0) and the slot (body 1): apart, away from the
    # gripper start, in the spawn box, at their heights
    assert (np.linalg.norm(pos[:, 0, :2] - pos[:, 1, :2], axis=-1)
            > 0.06).all()
    assert (np.linalg.norm(pos[..., :2] - core.tip_initial[:2], axis=-1)
            > 0.06).all()
    assert (pos[..., :2] >= core.object_lower[:2] - 1e-6).all()
    assert (pos[..., :2] <= core.object_upper[:2] + 1e-6).all()
    np.testing.assert_array_equal(pos[..., 2], np.broadcast_to(
        np.float32([0.06, 0.03]), (count, 2)))
    # each turned about z alone by a yaw in [-pi, pi]
    np.testing.assert_array_equal(quat[..., 1:3], 0.0)
    yaw = 2 * np.arctan2(quat[..., 3], quat[..., 0])
    assert (np.abs(yaw) <= np.pi + 1e-5).all() and yaw.std() > 1.0
    # built as the JAX package builds it (to the last bit of sin and cos),
    # zeros' signs included, so that the singular ZYZ angles of an upright
    # object come out alike
    yaws = np.random.default_rng(0).uniform(-np.pi, np.pi, 64).astype(
        np.float32)
    mine = n(tq.yaw_quat_zyz(t(yaws)))
    theirs = np.asarray(jq.yaw_quat_zyz(jnp.asarray(yaws)))
    np.testing.assert_allclose(mine, theirs, atol=1.2e-7)
    np.testing.assert_array_equal(np.signbit(mine), np.signbit(theirs))
    assert (mine[:, 1:3] == 0).all() and np.signbit(mine[:, 1:3]).any()
    np.testing.assert_allclose(
        n(tq.quat_to_euler_zyz(t(mine))),
        np.asarray(jq.quat_to_euler_zyz(jnp.asarray(mine))), atol=1e-6)
    np.testing.assert_array_equal(n(state.ee_target_rot),
                                  np.broadcast_to(jins._DOWN_ZYZ, (count, 3)))
    # the goal: the slot's pocket centre at the rectangle's height
    c, s = np.cos(yaw[:, 1]), np.sin(yaw[:, 1])
    goal = n(state.desired_goal)
    np.testing.assert_allclose(goal[:, :2], pos[:, 1, :2]
                               - 0.03 * np.stack([c, s], -1), atol=1e-6)
    np.testing.assert_allclose(goal[:, 2], 0.06, atol=1e-7)
    assert not n(obs['subtask_rewards']['insert_done']).any()
    # a reseeded reset repeats itself
    again, _ = env.reset(seed=3)
    np.testing.assert_array_equal(n(again.phys.body_pos), pos)


def _moved_state(count, seed):
    """A port reset state with the objects pushed and turned, the arm
    moving and a contact force on the gripper: what a step hands to
    `step_finish`."""
    env = make_vec_env(num_envs=count, task='insertion', device='cpu',
                       seed=seed)
    state, _ = env.reset()
    rng = np.random.default_rng(seed)
    ph = state.phys
    moved = ph._replace(
        q=ph.q + t(rng.uniform(-0.3, 0.3, ph.q.shape)),
        qd=t(rng.uniform(-0.5, 0.5, ph.qd.shape)),
        fq=t(rng.uniform(-0.035, 0.035, ph.fq.shape)),
        fqd=t(rng.uniform(-0.1, 0.1, ph.fqd.shape)),
        body_pos=ph.body_pos + t(rng.uniform(-0.05, 0.05, ph.body_pos.shape)),
        body_quat=tq.mul(tq.yaw_quat_zyz(t(rng.uniform(
            -3, 3, ph.body_pos.shape[:2]))), ph.body_quat),
        ee_contact_force=t(rng.uniform(-40, 40, (count, 3))))
    # one env's rectangle sits in the slot's pocket: insert_done
    slot_target, _ = env.core._slot_target(moved)
    bp = moved.body_pos.clone()
    bp[0, 0] = slot_target[0] + t([0.0, 0.0, 0.03])
    bq = moved.body_quat.clone()
    bq[0, 0] = bq[0, 1]
    moved = moved._replace(body_pos=bp, body_quat=bq)
    return env, state._replace(phys=moved, steps=state.steps + 1)


def test_env_pieces_match_jax():
    """`_generate_goal`, and `step_finish` with the state noise off (the
    observation, the objects' state, the subtask rewards with their done
    flags and goal pairs, the reward) on one shared state, against the JAX
    package's."""
    count = 16
    env, state = _moved_state(count, seed=1)
    jenv = _jenv()
    np.testing.assert_allclose(env.core.rest_pose, jenv.rest_pose, atol=1e-5)
    jstate = _to_jax_state(state_to_numpy(state))
    got = env.core._generate_goal(state).desired_goal
    want = jax.vmap(jenv._generate_goal)(jstate).desired_goal
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5)
    _, obs, reward, achieved = env.core.step_finish(state)
    _, jobs, jrew, jach = jax.vmap(jenv.step_finish)(jstate)
    thr = env.cfg.distance_threshold
    for k, v in obs.items():
        if k != 'subtask_rewards':
            np.testing.assert_allclose(n(v), np.asarray(jobs[k]), atol=5e-3,
                                       err_msg=k)
    sub, jsub = obs['subtask_rewards'], jobs['subtask_rewards']
    assert set(sub) == set(jsub)
    for k in sub:
        if not k.endswith('_done'):
            np.testing.assert_allclose(n(sub[k]), np.asarray(jsub[k]),
                                       atol=5e-3, err_msg=k)
    for task in ('pick_up', 'reach', 'insert'):
        d = -np.asarray(jsub[task])
        sure = np.abs(d - thr) >= 5e-3
        np.testing.assert_array_equal(n(sub[task + '_done'])[sure],
                                      np.asarray(jsub[task + '_done'])[sure])
    assert n(sub['insert_done'])[0] and not n(sub['insert_done'])[1:].any()
    d = np.linalg.norm(np.asarray(jobs['achieved_goal'])
                       - np.asarray(jobs['desired_goal']), axis=-1)
    sure = np.abs(d - thr) >= 5e-3
    np.testing.assert_array_equal(n(reward)[sure], np.asarray(jrew)[sure])
    np.testing.assert_array_equal(n(achieved)[sure], np.asarray(jach)[sure])


def test_state_noise():
    """With ``state_noise`` the policy state, less its finger closeness,
    gains N(0, 0.05) noise from the env's generator; nothing else moves."""
    count = 4096
    env, state = _moved_state(count, seed=2)
    clean = env.core._get_obs(state)
    noisy_env = make_vec_env(num_envs=count, task='insertion', device='cpu',
                             state_noise=True)
    noisy = noisy_env.core._get_obs(state, torch.Generator().manual_seed(0))
    for k, v in clean.items():
        if k not in ('policy_state', 'subtask_rewards'):
            np.testing.assert_array_equal(n(noisy[k]), n(v), err_msg=k)
    d = n(noisy['policy_state'] - clean['policy_state'])
    np.testing.assert_array_equal(d[:, 16], 0.0)
    assert abs(d[:, :16].mean()) < 3e-3
    np.testing.assert_allclose(d[:, :16].std(0), 0.05, rtol=0.05)
    # through the vec env: the noise comes from its seeded generator
    noisy_env.generator.manual_seed(1)
    _, a = noisy_env.core.reset(4, noisy_env.generator)
    noisy_env.generator.manual_seed(1)
    _, b = noisy_env.core.reset(4, noisy_env.generator)
    np.testing.assert_array_equal(n(a['policy_state']), n(b['policy_state']))


def _as_quat(poses):
    """(N, 6k) positions and ZYZ Euler angles -> positions and unit
    quaternions with w >= 0."""
    o = np.array(poses).reshape(poses.shape[0], -1, 6)
    q = n(tq.euler_zyz_to_quat(t(o[..., 3:])))
    q = np.where(q[..., :1] < 0, -q, q)
    return np.concatenate([o[..., :3], q], -1).reshape(poses.shape[0], -1)


def test_step_matches_jax(tmp_path):
    """One step of the port's plain path from a port reset state, with
    actions that turn the gripper, against the JAX composition (decode, IK
    at 8 iterations toward the accumulator's quaternion, 100 substeps,
    `step_finish`): the observation, the objects' poses with rotations as
    quaternions, the goal and the reward."""
    env = make_vec_env(num_envs=N_ENVS, task='insertion', device='cpu',
                       seed=5)
    state, _ = env.reset()
    jenv = _jenv()
    jstate = _to_jax_state(state_to_numpy(state))
    a = np.random.default_rng(7).uniform(-1, 1, (N_ENVS, 7)).astype(
        np.float32)
    jstate, f_t = jax.vmap(jenv.step_decode_pre)(jstate, jnp.asarray(a))
    quat = jax.vmap(jq.euler_zyz_to_quat)(jstate.ee_target_rot)
    q_t = _ik8(jstate.ee_target, quat, jstate.phys.q,
               jnp.asarray(jenv.rest_pose))
    zeros = jnp.zeros((N_ENVS,), jnp.float32)
    phys = _xla()(jstate.phys, JD.Controls(
        q_target=q_t, f_target=f_t, door_motor_on=zeros > 0,
        door_target=zeros), 100)
    jstate = jstate._replace(phys=phys, steps=jstate.steps + 1)
    _, jobs, jrew, _ = jax.vmap(jenv.step_finish)(jstate)
    state, obs, reward, done, _ = env.step(state, t(a))
    np.testing.assert_allclose(n(state.ee_target_rot),
                               np.asarray(jstate.ee_target_rot), atol=1e-6)
    np.testing.assert_allclose(n(obs['observation']),
                               np.asarray(jobs['observation']), atol=5e-3)
    for k in ('auxiliary_task_state', 'achieved_goal', 'desired_goal'):
        np.testing.assert_allclose(_as_quat(n(obs[k])),
                                   _as_quat(np.asarray(jobs[k])), atol=5e-3,
                                   err_msg=k)
    np.testing.assert_array_equal(n(reward), np.asarray(jrew))
    assert not n(done).any()
    assert env.core.ik.launches == 0 and env.core.engine.launches == 0
    # the state goes to the JAX package's checkpoint format and back
    leaves = state_to_numpy(state)
    back = state_to_numpy(state_from_numpy(leaves, device='cpu'))
    for k, v in leaves.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize('kw', [dict(gripper='robotiq85'),
                                dict(image_observation=True)])
def test_later_slices_raise(kw):
    with pytest.raises(NotImplementedError, match='later slice'):
        make_vec_env(num_envs=2, task='insertion', device='cpu', **kw)
