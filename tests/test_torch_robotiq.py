"""The Robotiq-85 gripper in the port against the JAX package, on the CPU.

The pads hang from link 7's origin on the mimic linkage: their position and
their velocity per unit closure rate depend on the closure angle, and that
velocity is not a unit vector (|vel| = ``KM.ROBOTIQ_ARM_LEN`` m/rad). Held
here, from numpy inputs made from a seed: the pad kinematics and
`fk.ee_frames` (1e-6), K1's plain version toward the Robotiq's tip (1e-4),
K2's and K3's plain versions against the XLA `Engine(gripper='robotiq85')`
on `tests/torch_common.py:robotiq_inputs` after 100 substeps (2e-3),
`robot_state` with both subtree masses, three steps of push and of
block_rearrange with 2 blocks at 16 envs against the JAX package's step
sequence (5e-3), a JAX `PhysicsState` carried through `interop`, the JAX
package's own grasp-and-lift on the port, and every Robotiq task's scenes
building and stepping through `make_vec_env` and `make_env`. The Pallas
kernels' Robotiq branches run only in interpret mode on the CPU (far too
slow for these tests), so the port is held against the XLA engine, as for
every earlier slice. Each XLA reference is compiled once per module and
serves every test of its scene.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pybullet_multigoal_gym_tpu  # noqa: F401  (JAX precision config)
from pybullet_multigoal_gym_tpu.config import EnvConfig as JaxConfig
from pybullet_multigoal_gym_tpu.envs import core as jcore
from pybullet_multigoal_gym_tpu.envs import multi_step as jms
from pybullet_multigoal_gym_tpu.envs import robot as jrobot
from pybullet_multigoal_gym_tpu.envs.single_step import KukaSingleStepEnv
from pybullet_multigoal_gym_tpu.model import kuka_model as JKM
from pybullet_multigoal_gym_tpu.ops import dynamics as JD
from pybullet_multigoal_gym_tpu.ops import fk as jfk
from pybullet_multigoal_gym_tpu.ops import ik as jik
from pybullet_multigoal_gym_tpu.ops import scene as JS
from pybullet_multigoal_gym_tpu_torch import make_env, make_vec_env
from pybullet_multigoal_gym_tpu_torch.envs import robot as R
from pybullet_multigoal_gym_tpu_torch.interop import (ENV_FIELDS,
                                                     state_from_numpy,
                                                     state_to_numpy)
from pybullet_multigoal_gym_tpu_torch.model import kuka_model as KM
from pybullet_multigoal_gym_tpu_torch.ops import dynamics as D
from pybullet_multigoal_gym_tpu_torch.ops import engine_plain as EP
from pybullet_multigoal_gym_tpu_torch.ops import fk, ik
from pybullet_multigoal_gym_tpu_torch.ops import multibody_plain as MP
from pybullet_multigoal_gym_tpu_torch.ops import scene as S
from pybullet_multigoal_gym_tpu_torch.ops.cuda_ik import CudaIK
from tests.torch_common import (ARM_FIELDS, BODY_FIELDS, NoisyEngine, n,
                                noise_bound, plain_run, robotiq_inputs, t,
                                torch_controls, torch_state,
                                workspace_targets)

torch.set_num_threads(1)

GRIP = 'robotiq85'
N_ENVS, N_STEPS = 16, 3


def _jax_tree(cls, d):
    return cls(**{k: jnp.asarray(v) for k, v in d.items()})


def _hold_to_xla(out, ref, fields):
    for f in fields:
        np.testing.assert_allclose(n(getattr(out, f)), n(getattr(ref, f)),
                                   atol=2e-3, err_msg=f)
    np.testing.assert_allclose(n(out.ee_contact_force),
                               n(ref.ee_contact_force), atol=2e-3 / D.DT_SUB)


# --------------------------------------------------------- kinematics
def _q_and_fq(count, seed):
    rng = np.random.default_rng(seed)
    q = (np.asarray(KM.KUKA_REST_POSE, np.float32)
         + rng.uniform(-0.5, 0.5, (count, 7)).astype(np.float32))
    fq = rng.uniform(0.0, KM.ROBOTIQ_JOINT_LIMIT, (count, 2)).astype(
        np.float32)
    return q, fq


def test_pads_match_jax():
    """The port's pads (`fk.robotiq_pads`, the Pallas kernel's order of
    sums) match the XLA engine's (`KM.robotiq_pad_kinematics`) to the last
    bits of the two libraries' sines and cosines, and `ee_frames` with the
    Robotiq-85 matches the JAX package's within 1e-6; the pad velocity per
    unit closure rate is the linkage's arm, not a unit vector."""
    q, fq = _q_and_fq(64, 0)
    ref = JKM.robotiq_pad_kinematics(jnp.asarray(fq), xp=jnp)
    out = fk.robotiq_pads(t(fq))
    for k in ('tab', 'center', 'vel'):
        np.testing.assert_allclose(n(out[k]), n(ref[k]), atol=3e-8,
                                   err_msg=k)
    np.testing.assert_allclose(np.linalg.norm(n(out['vel']), axis=-1),
                               KM.ROBOTIQ_ARM_LEN, rtol=1e-6)
    ref = jfk.ee_frames(jnp.asarray(q), jnp.asarray(fq), gripper=GRIP)
    out = fk.ee_frames(t(q), t(fq), GRIP)
    assert sorted(ref) == sorted(out)
    for k in ref:
        np.testing.assert_allclose(n(out[k]), n(ref[k]), atol=1e-6,
                                   err_msg=k)
    # the engines' pads: fk_chain's centres and axes are ee_frames' rotated
    ch = EP.fk_chain(t(q), t(fq), GRIP)
    np.testing.assert_array_equal(n(ch['fpos']), n(out['finger_pos']))
    np.testing.assert_allclose(
        n(ch['faxis']), n(R.quatm.rotate(out['finger_rot'],
                                         out['finger_axis_l7'])), atol=1e-7)


@pytest.mark.parametrize('iters', [8, 40])
def test_ik_plain_matches_jax(iters):
    """K1's plain version toward the Robotiq-85's tip (0.18 m out along
    link 7's z), and the wrapper's CPU path, against the JAX package."""
    rng = np.random.default_rng(1)
    tgt = workspace_targets(rng, 16)
    q0 = (np.asarray(KM.KUKA_REST_POSE, np.float32)
          + rng.uniform(-0.2, 0.2, (16, 7)).astype(np.float32))
    ref = jax.jit(lambda a, b: jik.solve(a, q_init=b, num_iters=iters,
                                         gripper=GRIP))(
        jnp.asarray(tgt), jnp.asarray(q0))
    out = ik.solve(t(tgt), q_init=t(q0), num_iters=iters, gripper=GRIP)
    np.testing.assert_allclose(n(out), n(ref), atol=1e-4)
    w = CudaIK(num_iters=iters, gripper=GRIP)
    np.testing.assert_array_equal(n(w.solve(t(tgt), q_init=t(q0))), n(out))
    assert w.tip_offset == [0.0, 0.0, np.float32(0.18)] and w.launches == 0
    if iters == 40:
        tip, _ = fk.tip_pose(out, GRIP)
        assert np.linalg.norm(n(tip) - tgt, axis=-1).max() < 1e-3


@pytest.mark.parametrize('gripper', ['parallel_jaw', 'robotiq85'])
def test_robot_state_matches_jax(gripper):
    """Closeness from the gripper's tabs, the finger velocity along its
    pad axis and the EE force sensor with its subtree's mass."""
    q, fq = _q_and_fq(16, 2)
    if gripper == 'parallel_jaw':
        fq = fq * (KM.FINGER_LIMIT / KM.ROBOTIQ_JOINT_LIMIT)
    rng = np.random.default_rng(3)
    qd, fqd, force = (rng.uniform(-1, 1, s).astype(np.float32)
                      for s in ((16, 7), (16, 2), (16, 3)))
    force *= 40.0
    ref = jax.jit(jax.vmap(lambda q_, qd_, fq_, fqd_, f_:
                           jrobot.robot_state(q_, qd_, fq_, fqd_, True, f_,
                                              gripper=gripper)))(
        *(jnp.asarray(x) for x in (q, qd, fq, fqd, force)))
    out = R.robot_state(t(q), t(qd), t(fq), t(fqd), True, t(force),
                        gripper=gripper)
    for k in ('gripper_xyz', 'gripper_rpy', 'gripper_finger_closeness',
              'gripper_vel_xyz', 'gripper_vel_rpy', 'gripper_finger_vel',
              'ee_joint_force'):
        # (the force sensor reads tens of newtons: an ulp there is 4e-6)
        np.testing.assert_allclose(n(out[k]), n(ref[k]), atol=1e-5,
                                   rtol=1e-6, err_msg=k)
    # the sensed subtree: the linkage weighs 0.36 kg more than the jaw
    flat = R.robot_state(t(q), t(qd), t(fq), t(fqd), True, t(force * 0.0),
                         gripper=gripper)['ee_joint_force']
    mass = (KM.ROBOTIQ_EE_SUBTREE_MASS if gripper == 'robotiq85'
            else KM.EE_SUBTREE_MASS)
    np.testing.assert_allclose(np.linalg.norm(n(flat), axis=-1),
                               mass * 9.81, rtol=1e-5)


# ------------------------------------------------ the engines against XLA
def _xla_run(eng):
    """``eng``'s substep loop, jitted and vmapped (a traced trip count)."""
    return jax.jit(jax.vmap(
        lambda s, c, k: jax.lax.fori_loop(0, k, lambda i, x: eng.substep(x, c),
                                          s), in_axes=(0, 0, None)))


@pytest.fixture(scope='module')
def xla_push():
    """push's scene with the Robotiq-85 under EE control, compiled once for
    N_ENVS envs: the K2 checks and the push main path share it."""
    return _xla_run(JD.Engine(JS.single_step_scene(True), gripper=GRIP))


@pytest.fixture(scope='module')
def xla_pair():
    """block_rearrange's scene of 2 blocks with the Robotiq-85 under EE
    control, compiled once for N_ENVS envs: the K3 checks and the
    block_rearrange main path share it."""
    return _xla_run(JD.Engine(JS.multi_step_scene(2), gripper=GRIP))


# K2's states after 100 substeps, with the lane groups each makes act
K2_CASES = {'grasp': ('finger-box', 'box-plane'), 'stops': (),
            'pad_table': ('finger-plane',)}


@pytest.mark.parametrize('kind', sorted(K2_CASES))
def test_engine_plain_matches_xla(xla_push, kind):
    """K2's plain version with the Robotiq-85 against the XLA engine after
    100 substeps (2e-3): the pads closing on a block, both fingers driven
    into their stops (the clamp to [0, 0.804] loses the velocity into
    either one) and the short pads pressed on the table."""
    st, ctl = robotiq_inputs(kind, N_ENVS, seed=4)
    ref = xla_push(_jax_tree(JD.PhysicsState, st), _jax_tree(JD.Controls, ctl),
                   100)
    sc = D.scene_consts(S.single_step_scene(True), gripper=GRIP)
    out, active = plain_run(sc, torch_state(st), torch_controls(ctl), 100)
    _hold_to_xla(out, ref, ARM_FIELDS + BODY_FIELDS)
    assert all(active[g] > 0 for g in K2_CASES[kind]), active
    fq = n(out.fq)
    if kind == 'stops':
        # driven beyond the range (even envs): at the stops, at rest
        np.testing.assert_array_equal(
            fq[::2], np.tile([0.0, np.float32(0.804)], (N_ENVS // 2, 1)))
        np.testing.assert_array_equal(n(out.fqd)[::2], 0.0)
        assert (fq >= 0.0).all() and (fq <= np.float32(0.804)).all()
    if kind == 'grasp':
        # stalled on the block's sides, short of the closed stop
        assert (fq > 0.5).all() and (fq < 0.62).all(), fq


def test_multibody_plain_matches_xla(xla_pair):
    """K3's plain version with the Robotiq-85, 2 blocks, against the XLA
    engine after 100 substeps (2e-3): the pads closing on a block; they
    stall on its sides."""
    st, ctl = robotiq_inputs('grasp', N_ENVS, seed=4, nb=2)
    ref = xla_pair(_jax_tree(JD.PhysicsState, st),
                   _jax_tree(JD.Controls, ctl), 100)
    sc = D.multibody_consts(S.multi_step_scene(2), gripper=GRIP)
    out = MP.control_step(sc, torch_state(st), torch_controls(ctl), 100)
    _hold_to_xla(out, ref, ARM_FIELDS + BODY_FIELDS)
    assert (n(out.fq) > 0.5).all() and (n(out.fq) < 0.62).all()
    assert np.abs(n(out.ee_contact_force)).max() > 1.0


def _env_errors(a, b):
    """Per-env max |a - b| over the state's arm and body fields."""
    return torch.stack([
        torch.as_tensor(np.abs(n(getattr(a, f)) - n(getattr(b, f)))
                        .reshape(a.q.shape[0], -1).max(1))
        for f in ARM_FIELDS + BODY_FIELDS]).max(0).values


def test_multibody_plain_matches_xla_pile(xla_pair):
    """The pads squeezing the top block of a pile of two (finger-box,
    box-box and box-plane lanes act): within 2e-3 of the XLA engine after
    2 substeps. After 100 the pile forks on the last bit: the plain
    version's own runs with 1-ulp noise in every substep part by up to
    2.4 in some envs, so there each env is held to the larger of 2e-3 and
    twice its spread over 8 such runs (`noise_bound`), and most envs stay
    within 2e-3."""
    st, ctl = robotiq_inputs('pile', N_ENVS, seed=4, nb=2)
    jst, jctl = _jax_tree(JD.PhysicsState, st), _jax_tree(JD.Controls, ctl)
    sc = D.multibody_consts(S.multi_step_scene(2), gripper=GRIP)
    st, ctl = torch_state(st), torch_controls(ctl)
    out, active = plain_run(sc, st, ctl, 2)
    _hold_to_xla(out, xla_pair(jst, jctl, 2), ARM_FIELDS + BODY_FIELDS)
    assert active['box-box'] > 0.5
    out = MP.control_step(sc, st, ctl, 100)
    e = _env_errors(out, xla_pair(jst, jctl, 100))
    bound, spread, _, _ = noise_bound(sc, st, ctl, 100, out, _env_errors,
                                      2e-3)
    assert (e <= bound).all(), (e, bound)
    assert int((e <= 2e-3).sum()) >= N_ENVS * 3 // 4, e
    assert float(spread.max()) > 0.1      # the fork the bound allows


def test_interop_carries_a_jax_state(xla_push):
    """A JAX Robotiq `PhysicsState` (the engine's own `init_state`, pads
    open) goes through `interop` unchanged and steps as the XLA engine
    steps it."""
    jeng = JD.Engine(JS.single_step_scene(True), gripper=GRIP)
    q0 = _robotiq_tip_q(0.21)
    one = jeng.init_state(q=jnp.asarray(q0),
                          body_pos=jnp.asarray([[-0.52, 0.0, 0.175]]),
                          fq=0.45)
    jst = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (N_ENVS,) + x.shape), one)
    leaves = {'.phys.' + f: np.asarray(getattr(jst, f))
              for f in JD.PhysicsState._fields}
    leaves.update(_env_leaves(N_ENVS))
    state = state_from_numpy(leaves, device='cpu')
    back = state_to_numpy(state)
    for k, v in leaves.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    ctl = dict(q_target=np.tile(q0, (N_ENVS, 1)),
               f_target=np.full((N_ENVS, 2), 0.804, np.float32),
               door_motor_on=np.zeros(N_ENVS, bool),
               door_target=np.zeros(N_ENVS, np.float32))
    ref = xla_push(jst, _jax_tree(JD.Controls, ctl), 100)
    sc = D.scene_consts(S.single_step_scene(True), gripper=GRIP)
    out = EP.control_step(sc, state.phys, torch_controls(ctl), 100)
    _hold_to_xla(out, ref, ARM_FIELDS + BODY_FIELDS)


def _env_leaves(count):
    """The env fields of a port reset state at ``count`` envs (the
    physics is replaced)."""
    env = make_vec_env(num_envs=count, task='push', gripper=GRIP,
                       device='cpu')
    leaves = state_to_numpy(env.reset()[0])
    return {'.' + f: leaves['.' + f] for f in ENV_FIELDS}


def _robotiq_tip_q(z):
    return n(ik.solve(torch.tensor([-0.52, 0.0, z]),
                      q_init=t(KM.KUKA_REST_POSE), gripper=GRIP))


def test_grasps_and_lifts_block():
    """The JAX package's `test_robotiq_grasps_and_lifts_block` on the
    port: the open pads close on a block (stalling at 0.5-0.62 rad after 2
    control steps) and the friction pinch carries it 6 cm up in 3 more."""
    eng = make_vec_env(num_envs=1, task='push', gripper=GRIP,
                       device='cpu').core.engine
    q0 = t(_robotiq_tip_q(0.175 + 0.035))
    st = D.init_state(1, q=q0, body_pos=t([[[-0.52, 0.0, 0.175]]]), fq=0.0)
    close = D.Controls(q_target=q0[None], f_target=torch.full((1, 2), 0.804),
                       door_motor_on=torch.zeros(1, dtype=torch.bool),
                       door_target=torch.zeros(1))
    for _ in range(2):
        st = eng.control_step(st, close)
    assert 0.5 < float(st.fq[0, 0]) < 0.62, st.fq
    q_up = ik.solve(torch.tensor([-0.52, 0.0, 0.175 + 0.095]), q_init=q0,
                    gripper=GRIP)
    for _ in range(3):
        st = eng.control_step(st, close._replace(q_target=q_up[None]))
    assert float(st.body_pos[0, 0, 2]) > 0.21, st.body_pos
    assert eng.launches == 0


# ------------------------------------------------------ the main paths
def _jax_env_state(env, leaves, keys):
    """The JAX package's `EnvState` for the port's state leaves, its
    structure from `reset` traced once (nothing compiled)."""
    like = jax.eval_shape(jax.vmap(env.reset), keys)[0]
    return jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(
            keys if jax.tree_util.keystr(path) == '.key'
            else leaves[jax.tree_util.keystr(path)], x.dtype), like)


N_NOISY = 4     # noisy copies of the main path's envs
# the in-step IK of the JAX package's fused-kernel path toward the
# Robotiq's tip, one program for every rest pose
_solve = jax.jit(jax.vmap(lambda tgt, q, rest: jik.solve(
    tgt, q_init=q, rest_pose=rest, num_iters=8, gripper=GRIP),
    in_axes=(0, 0, None)))


def _main_path(task, jenv, run, **kw):
    """3 seeded steps of the JAX package's fused-kernel step sequence
    (vmapped ``step_decode_pre`` -> ``ik.solve(num_iters=8)`` toward the
    Robotiq's tip -> 100 substeps of the XLA engine -> ``step_finish``)
    from a port reset state at N_ENVS envs, and before each of them the
    port's plain path given the JAX package's state, with the same
    actions. At reset the Robotiq's pads lie 3.5 cm inside the table (the
    rest pose puts its tip, 0.18 m out, 1 mm above the table, in both
    packages), the table throws the arm up, and the pads' contacts fork on
    the last bit within a step. So each env's observation after a step is
    held to the larger of 5e-3 and twice its spread over N_NOISY copies
    stepped with 1-ulp noise in every substep (`NoisyEngine`, run where
    some env parts by more than 5e-3); most envs stay within 5e-3, and
    there the rewards agree where the distance is not within 5e-3 of the
    threshold. Each step starts from the JAX
    package's state, so that the engines' differences within their
    physics bound (2e-3 a control step) do not add up over the steps."""
    env = make_vec_env(num_envs=N_ENVS, task=task, gripper=GRIP,
                       device='cpu', seed=1, **kw)
    assert env.core.scene.gripper == GRIP and env.core.ik.gripper == GRIP
    np.testing.assert_allclose(env.core.rest_pose, jenv.rest_pose, atol=1e-5)
    np.testing.assert_allclose(env.core.tip_rest, jenv.tip_rest, atol=1e-5)
    for attr in ('gripper_abs_joint_limit', 'gripper_grasp_block_state',
                 'finger_scale'):
        assert getattr(env.core, attr) == getattr(jenv, attr), attr
    state, _ = env.reset()
    np.testing.assert_allclose(n(state.phys.fq), 0.804)
    noisy_env = make_vec_env(num_envs=N_ENVS * N_NOISY, task=task,
                             gripper=GRIP, device='cpu', **kw)
    noisy_env.core.engine = NoisyEngine(noisy_env.core.scene)
    jstate = _jax_env_state(jenv, state_to_numpy(state),
                            jax.random.split(jax.random.PRNGKey(1), N_ENVS))
    rest = jnp.asarray(jenv.rest_pose)
    decode = jax.jit(jax.vmap(jenv.step_decode_pre))
    finish = jax.jit(jax.vmap(jenv.step_finish))
    rng = np.random.default_rng(0)
    actions = rng.uniform(-1, 1, (N_STEPS, N_ENVS, env.cfg.action_dim)
                          ).astype(np.float32)
    zeros = jnp.zeros((N_ENVS,), jnp.float32)
    keys = ('observation', 'policy_state', 'achieved_goal', 'desired_goal')
    for a in actions:
        leaves = {jax.tree_util.keystr(p): np.array(x) for p, x in
                  jax.tree_util.tree_flatten_with_path(jstate)[0]}
        state = state_from_numpy(leaves, device='cpu')
        noisy = state_from_numpy({k: np.concatenate([v] * N_NOISY)
                                  for k, v in leaves.items()}, device='cpu')
        jstate, f_t = decode(jstate, jnp.asarray(a))
        q_t = _solve(jstate.ee_target, jstate.phys.q, rest)
        phys = run(jstate.phys, JD.Controls(
            q_target=q_t, f_target=f_t, door_motor_on=zeros > 0,
            door_target=zeros), 100)
        jstate = jstate._replace(phys=phys, steps=jstate.steps + 1)
        out = finish(jstate)
        jstate, jobs, jrew = out[0], out[1], out[2]
        state, obs, reward, done, _ = env.step(state, t(a))
        err = np.max([np.abs(n(obs[k]) - np.asarray(jobs[k])).max(1)
                      for k in keys], 0)
        flat = err <= 5e-3
        if not flat.all():
            _, nobs, *_ = noisy_env.step(noisy, t(np.concatenate(
                [a] * N_NOISY)))
            spread = np.max([np.abs(n(nobs[k]).reshape(N_NOISY, N_ENVS, -1)
                                    - n(obs[k])).max((0, 2))
                             for k in keys], 0)
            assert (err <= np.maximum(5e-3, 2.0 * spread)).all(), (err,
                                                                   spread)
        assert flat.sum() >= N_ENVS * 3 // 4, err
        d = np.linalg.norm(np.asarray(jobs['achieved_goal'])
                           - np.asarray(jobs['desired_goal']), axis=-1)
        sure = flat & (np.abs(d - env.cfg.distance_threshold) >= 5e-3)
        np.testing.assert_array_equal(n(reward)[sure], np.asarray(jrew)[sure])
        assert not n(done).any()
    assert env.core.ik.launches == 0 and env.core.engine.launches == 0


def test_push_main_path_matches_jax(xla_push):
    _main_path('push', KukaSingleStepEnv(JaxConfig(task='push',
                                                   gripper=GRIP)), xla_push)


def test_block_rearrange_main_path_matches_jax(xla_pair):
    _main_path('block_rearrange', jms.KukaMultiBlockEnv(JaxConfig(
        task='block_rearrange', num_block=2, gripper=GRIP)), xla_pair,
        num_block=2)


# --------------------------------------------------- every Robotiq scene
SINGLE = ['reach', 'push', 'pick_and_place', 'slide']


@pytest.mark.parametrize('joint_control', [False, True])
def test_every_task_builds_and_steps(joint_control):
    """Through `make_vec_env`, with the Robotiq-85: the four single-step
    tasks, and block_stack and block_rearrange with 1-5 blocks, build
    their scene with the gripper's constants and reset with the pads
    closed (0.804 rad); a few of them, one of each kernel instance kind,
    step once on the CPU with finite observations."""
    stepped = ({'reach', 'slide', ('block_stack', 2)} if joint_control
               else {'push', 'pick_and_place', ('block_rearrange', 1)})
    cases = SINGLE + [(task, nb) for task in ('block_stack', 'block_rearrange')
                      for nb in range(1, 6)]
    for case in cases:
        task, kw = (case, {}) if isinstance(case, str) else (
            case[0], dict(num_block=case[1]))
        env = make_vec_env(num_envs=2, task=task, gripper=GRIP,
                           joint_control=joint_control, device='cpu', **kw)
        assert env.core.scene.gripper == GRIP
        assert env.core.scene.finger == D.finger_consts(GRIP)
        state, obs = env.reset()
        np.testing.assert_allclose(n(state.phys.fq), 0.804)
        if case in stepped:
            a = torch.rand((2, env.cfg.action_dim),
                           generator=torch.Generator().manual_seed(0)) * 2 - 1
            state, obs, *_ = env.step(state, a)
            assert all(torch.isfinite(v).all() for v in obs.values()
                       if torch.is_tensor(v)), case


def test_make_env_robotiq():
    """The single-env front with the Robotiq-85: its id, and a step."""
    env = make_env(task='pick_and_place', gripper=GRIP, device='cpu')
    obs = env.reset()
    assert 'Robotiq85Grip' in env.env_id
    obs, reward, done, info = env.step(env.action_space.sample())
    assert np.isfinite(obs['observation']).all() and not done
