"""The port's multi-step slice against the JAX package, on the CPU: kernel
K3's plain version (`ops/multibody_plain.py`) and the block_stack and
block_rearrange envs (`envs/multi_step.py`).

The JAX side of the physics is the XLA engine (`ops/dynamics.py:Engine`,
whose contact plan uses the same 9- and 10-lane manifolds as the Pallas
kernel K3), compiled once for the module as one vmapped loop of substeps
over ``N_ENVS`` envs at 2 blocks; the env tests run the JAX package's step
sequence around it (``step_decode_pre`` -> ``ik.solve(num_iters=8)`` -> 100
substeps -> ``step_finish``). Both sides start from the same state, carried
across in the path-keyed checkpoint format (`interop.py`). Torch's RNG
cannot reproduce JAX keys, so the port's resets are checked by their
invariants.

Tolerances: 1e-5 for the edge-lane geometry; 2e-3 for the state after 2
and 100 substeps, the bound the JAX package holds its Pallas engines to
against its XLA engine (the EE force is an impulse over dt, so the same
bound over dt); observations 5e-3 over 3 steps, rewards equal except where
the goal distance lies within 5e-3 of the threshold.
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
from pybullet_multigoal_gym_tpu.envs import core as jcore
from pybullet_multigoal_gym_tpu.envs import multi_step as jms
from pybullet_multigoal_gym_tpu.ops import dynamics as JD
from pybullet_multigoal_gym_tpu.ops import ik as jik
from pybullet_multigoal_gym_tpu.ops import pallas_engine as PE
from pybullet_multigoal_gym_tpu.ops import pallas_multibody as PM
from pybullet_multigoal_gym_tpu.ops import scene as JS
from pybullet_multigoal_gym_tpu.utils import checkpoint
from pybullet_multigoal_gym_tpu.utils.demonstrator import (
    StepDemonstrator as JaxDemonstrator)
from pybullet_multigoal_gym_tpu_torch import make_vec_env
from pybullet_multigoal_gym_tpu_torch.envs import multi_step
from pybullet_multigoal_gym_tpu_torch.interop import (ENV_FIELDS,
                                                      state_from_numpy,
                                                      state_to_numpy)
from pybullet_multigoal_gym_tpu_torch.maths import quat as tq
from pybullet_multigoal_gym_tpu_torch.ops import dynamics as D
from pybullet_multigoal_gym_tpu_torch.ops import engine_plain as EP
from pybullet_multigoal_gym_tpu_torch.ops import multibody_plain as MP
from pybullet_multigoal_gym_tpu_torch.ops import scene as S
from pybullet_multigoal_gym_tpu_torch.utils.demonstrator import (
    StepDemonstrator, default_demonstrations)
from tests.torch_common import (ARM_FIELDS, BODY_FIELDS, multi_inputs, n, t,
                                torch_controls, torch_state)

torch.set_num_threads(1)

N_ENVS, N_STEPS = 8, 3
TILE = 1024


# ------------------------------------------------------------ edge lane
def _unit_quats(rng, count):
    q = rng.normal(size=(count, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_edge_lane_matches_tiles():
    """Two tilted cubes a little apart: the edge-edge candidate against
    `pallas_engine.edge_lane_tiles` on (8, 128) tiles."""
    rng = np.random.default_rng(0)
    ca = rng.uniform(-0.01, 0.01, (TILE, 3)).astype(np.float32)
    cb = (ca + rng.uniform(-0.032, 0.032, (TILE, 3))).astype(np.float32)
    qa, qb = _unit_quats(rng, TILE), _unit_quats(rng, TILE)
    h = (0.015, 0.015, 0.015)

    def tiles(x):
        return jnp.asarray(np.ascontiguousarray(x.T).reshape(-1, 8, 128))

    ref = PE.edge_lane_tiles(tiles(ca), PE.qmat(tiles(qa)), h, tiles(cb),
                             PE.qmat(tiles(qb)), h)
    out = EP.edge_lane(t(ca), tq.to_matrix(t(qa)), h, t(cb),
                       tq.to_matrix(t(qb)), h, 1.0)[0]
    for got, want in zip((out.pt, out.nrm, out.pen, out.active), ref):
        want = np.asarray(want)
        want = want.reshape(want.shape[0], -1).T if want.ndim == 3 \
            else want.reshape(-1)
        act = n(out.active) > 0     # where no lane acts its point is moot
        np.testing.assert_allclose(n(got)[act], want[act], atol=1e-5)
    np.testing.assert_array_equal(n(out.active), np.asarray(ref[3]).reshape(-1))
    assert 10 < n(out.active).sum() < TILE - 10


# ------------------------------------------------------------ the plan
@pytest.mark.parametrize('nb', [1, 2, 5])
@pytest.mark.parametrize('joint_control', [False, True])
def test_lane_plan_matches_pallas_count(nb, joint_control):
    """The plain version's lanes are the Pallas kernel's: as many (33 / 67
    / 239 at 1 / 2 / 5 blocks under EE control), and the groups in its
    order."""
    spec = S.multi_step_scene(nb)
    sc = D.multibody_consts(spec, ik_workspace=not joint_control)
    plan = MP.lane_plan(sc)
    assert len(plan) == PM.count_lanes(JS.multi_step_scene(nb),
                                       ik_workspace=not joint_control)
    groups = [MP.lane_group(l) for l in plan]
    head = (['box-plane'] * 4 + ['finger-box'] * 18) * nb
    head += ['box-box'] * (10 * nb * (nb - 1) // 2) + ['finger-plane'] * 8
    assert groups[:len(head)] == head
    assert set(groups[len(head):]) <= {'sphere-plane', 'sphere-box'}
    st = torch_state(multi_inputs(nb, 'drop', 2)[0])
    lanes = MP.build_lanes(sc, EP.fk_chain(st.q, st.fq), st.body_pos,
                           st.body_quat, tq.to_matrix(st.body_quat))
    assert all(x.shape[1] == len(plan) for x in lanes)


def test_unsupported_scenes_raise():
    """What later slices bring: the revolving chest door and cylinder
    bodies."""
    with pytest.raises(NotImplementedError, match='later slice'):
        D.multibody_consts(S.multi_step_scene(2, True, 'revolving'))
    with pytest.raises(NotImplementedError, match='later slice'):
        D.multibody_consts(S.single_step_scene(True, 'long_table'))


def test_insertion_scene_builds():
    """A pinned body builds: the slot's mass 0 gives inverse mass and
    inertia 0, as the XLA engine has them, and a pinned mask; the plan's
    geom pairs are those of two free bodies (none here)."""
    sc = D.multibody_consts(S.insertion_scene())
    eng = JD.Engine(JS.insertion_scene())
    np.testing.assert_allclose(sc.inv_mass, eng.body_inv_mass, rtol=1e-7)
    np.testing.assert_allclose(sc.inv_inertia, eng.body_inv_inertia,
                               rtol=1e-6)
    assert sc.pinned == (False, True) and sc.inv_mass[1] == 0.0
    assert sc.free_geoms == [0] and sc.pinned_geoms == [1, 2, 3, 4]
    assert sc.geom_pairs == []


@pytest.mark.parametrize('keys', [('slot', 'cube'), ('rectangle',)])
def test_shape_assemble_scenes_build(keys):
    """Bodies of several geoms and sizes build: the geom table is the
    scene's, and a body's inertia is its origin geom's alone (the slot's is
    its base bar's, its two prongs add none), as the XLA engine has it."""
    spec = S.shape_assemble_scene(keys)
    sc = D.multibody_consts(spec)
    a = JS.shape_assemble_scene(keys).np_arrays()
    np.testing.assert_array_equal(sc.geom_body, a['geom_body'])
    np.testing.assert_array_equal(np.float32(sc.geom_half), a['geom_half'])
    np.testing.assert_array_equal(np.float32(sc.geom_pos), a['geom_pos'])
    eng = JD.Engine(JS.shape_assemble_scene(keys))
    np.testing.assert_allclose(sc.inv_inertia, eng.body_inv_inertia,
                               rtol=1e-6)
    np.testing.assert_allclose(sc.inv_mass, eng.body_inv_mass, rtol=1e-7)
    base = S.body_inertia_diag(100.0, sc.geom_half[0])
    np.testing.assert_allclose(sc.inv_inertia[0], 1.0 / base, rtol=1e-6)


def test_one_block_matches_k2():
    """One block: the multi-step scene is push's (the same block, plane and
    33 lanes), so K3's plain version steps as K2's does."""
    spec1, push = S.multi_step_scene(1), S.single_step_scene(True)
    for k in ('body_mass', 'body_friction', 'geom_half', 'geom_pos',
              'geom_type'):
        np.testing.assert_array_equal(spec1.np_arrays()[k],
                                      push.np_arrays()[k])
    assert (spec1.plane_z, spec1.plane_friction) == (push.plane_z,
                                                     push.plane_friction)
    sc2, sc3 = D.scene_consts(push), D.multibody_consts(spec1)
    assert (sc2.plane_mask, (sc2.geom_mask,)) == (sc3.plane_mask,
                                                  sc3.geom_mask)
    st, ctl = multi_inputs(1, 'contact', 16, seed=3)
    st, ctl = torch_state(st), torch_controls(ctl)
    a = EP.control_step(sc2, st, ctl, 2)
    b = MP.control_step(sc3, st, ctl, 2)
    for f in ARM_FIELDS + BODY_FIELDS:
        np.testing.assert_allclose(n(getattr(b, f)), n(getattr(a, f)),
                                   atol=2e-3, err_msg=f)
    np.testing.assert_allclose(n(b.ee_contact_force), n(a.ee_contact_force),
                               atol=2e-3 / D.DT_SUB)
    assert np.abs(n(b.ee_contact_force)).max() > 1.0


# -------------------------------------------------- against the XLA engine
@pytest.fixture(scope='module')
def xla2():
    """The XLA engine at 2 blocks, compiled once: ``run(state, controls,
    n_substeps)`` over a batch of ``N_ENVS`` envs (a traced trip count)."""
    eng = JD.Engine(JS.multi_step_scene(2))
    return jax.jit(jax.vmap(
        lambda s, c, k: jax.lax.fori_loop(0, k, lambda i, x: eng.substep(x, c),
                                          s), in_axes=(0, 0, None)))


def _jax_tree(cls, d):
    return cls(**{k: jnp.asarray(v) for k, v in d.items()})


def _hold_to_xla(out, ref):
    for f in ARM_FIELDS + BODY_FIELDS:
        np.testing.assert_allclose(n(getattr(out, f)), n(getattr(ref, f)),
                                   atol=2e-3, err_msg=f)
    np.testing.assert_allclose(n(out.ee_contact_force),
                               n(ref.ee_contact_force), atol=2e-3 / D.DT_SUB)


@pytest.mark.parametrize('kind,n_sub', [('drop', 2), ('contact', 2),
                                        ('drop', 100)])
def test_control_step_plain_matches_xla(xla2, kind, n_sub):
    """2 blocks: the JAX package's dropped blocks, and a pile of blocks the
    fingers squeeze (finger-box, box-box and finger-plane lanes act)."""
    st, ctl = multi_inputs(2, kind, N_ENVS, seed=4)
    ref = xla2(_jax_tree(JD.PhysicsState, st), _jax_tree(JD.Controls, ctl),
               n_sub)
    sc = D.multibody_consts(S.multi_step_scene(2))
    out = MP.control_step(sc, torch_state(st), torch_controls(ctl), n_sub)
    _hold_to_xla(out, ref)
    if kind == 'contact':
        assert np.abs(n(out.ee_contact_force)).max() > 1.0


@pytest.mark.slow
def test_control_step_plain_matches_xla_five_blocks():
    """5 blocks (block_stack's scene), 2 substeps on the pile."""
    eng = JD.Engine(JS.multi_step_scene(5))
    run = jax.jit(jax.vmap(lambda s, c: eng.substep(eng.substep(s, c), c)))
    st, ctl = multi_inputs(5, 'contact', N_ENVS, seed=4)
    ref = run(_jax_tree(JD.PhysicsState, st), _jax_tree(JD.Controls, ctl))
    sc = D.multibody_consts(S.multi_step_scene(5))
    _hold_to_xla(MP.control_step(sc, torch_state(st), torch_controls(ctl), 2),
                 ref)


# -------------------------------------------------- the env's main path
def _to_jax_state(leaves):
    """The JAX `EnvState` of path-keyed leaves (a throwaway per-env key)."""
    n_envs = leaves['.steps'].shape[0]
    phys = JD.PhysicsState(**{f: jnp.asarray(leaves['.phys.' + f])
                              for f in JD.PhysicsState._fields})
    return jcore.EnvState(phys=phys,
                          key=jax.random.split(jax.random.PRNGKey(0), n_envs),
                          **{f: jnp.asarray(leaves['.' + f])
                             for f in ENV_FIELDS})


# the in-step IK of the JAX package's fused-kernel path, one program for
# every rest pose
_solve = jax.jit(jax.vmap(lambda tgt, q, rest: jik.solve(
    tgt, q_init=q, rest_pose=rest, num_iters=8), in_axes=(0, 0, None)))


@pytest.mark.parametrize('task,kw', [
    ('block_rearrange', {}), ('block_stack', dict(task_decomposition=True))])
def test_main_path_matches_jax(xla2, task, kw, tmp_path):
    """3 seeded steps of the port (plain path) and of the JAX package's step
    sequence from one port reset state."""
    env = make_vec_env(num_envs=N_ENVS, task=task, num_block=2, device='cpu',
                       seed=1, **kw)
    state, _ = env.reset()
    leaves = state_to_numpy(state)
    # the state round-trips through the JAX package's checkpoint format
    jstate = _to_jax_state(leaves)
    checkpoint.save(str(tmp_path / 'state'), jstate)
    with np.load(str(tmp_path / 'state.npz')) as f:
        back = state_to_numpy(state_from_numpy(dict(f), device='cpu'))
    for k, v in leaves.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)

    jenv = jms.KukaMultiBlockEnv(JaxConfig(task=task, num_block=2, **kw))
    np.testing.assert_allclose(env.core.rest_pose, jenv.rest_pose, atol=1e-5)
    decode = jax.jit(jax.vmap(jenv.step_decode_pre))
    finish = jax.jit(jax.vmap(jenv.step_finish))
    rest = jnp.asarray(jenv.rest_pose)
    rng = np.random.default_rng(0)
    actions = rng.uniform(-1, 1, (N_STEPS, N_ENVS, env.cfg.action_dim)
                          ).astype(np.float32)
    zeros = jnp.zeros((N_ENVS,), jnp.float32)
    for a in actions:
        jstate, f_t = decode(jstate, jnp.asarray(a))
        q_t = _solve(jstate.ee_target, jstate.phys.q, rest)
        phys = xla2(jstate.phys, JD.Controls(
            q_target=q_t, f_target=f_t, door_motor_on=zeros > 0,
            door_target=zeros), 100)
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
        assert not n(done).any()
    assert env.core.ik.launches == 0 and env.core.engine.launches == 0


# -------------------------------------------- curriculum and sub-goals
@pytest.mark.parametrize('nc', [1, 2, 3, 5])
def test_update_curriculum_prob_matches_jax(nc):
    rng = np.random.default_rng(nc)
    per = 10.0
    prob = rng.uniform(0, 1, (64, nc)).astype(np.float32)
    counts = rng.integers(0, 2 * int(per), (64, nc)).astype(np.float32)
    want = jax.vmap(lambda p, c: jms.update_curriculum_prob(p, c, nc, per))(
        jnp.asarray(prob), jnp.asarray(counts))
    got = multi_step.update_curriculum_prob(t(prob), t(counts), nc, per)
    np.testing.assert_array_equal(n(got), np.asarray(want))


@pytest.mark.parametrize('grip_informed', [False, True])
def test_sub_goals_match_jax(grip_informed):
    """`_stack_subgoals` and `set_sub_goal` on one port reset state of
    block_stack with 3 blocks."""
    kw = dict(task='block_stack', num_block=3, task_decomposition=True,
              grip_informed_goal=grip_informed)
    env = make_vec_env(num_envs=6, device='cpu', seed=2, **kw)
    state, _ = env.reset()
    # the two methods read only the config and the block count
    jenv = types.SimpleNamespace(cfg=JaxConfig(**kw), nb=3)
    jenv.set_sub_goal = functools.partial(jms.KukaMultiBlockEnv.set_sub_goal,
                                          jenv)
    jenv._stack_subgoals = functools.partial(
        jms.KukaMultiBlockEnv._stack_subgoals, jenv)
    args = (state.phys.body_pos, state.target_xyzs, state.block_order)
    want = jax.vmap(jenv._stack_subgoals)(*(jnp.asarray(n(x)) for x in args))
    np.testing.assert_array_equal(n(env.core._stack_subgoals(*args)),
                                  np.asarray(want))
    np.testing.assert_array_equal(n(state.sub_goals), np.asarray(want))
    jstate = _to_jax_state(state_to_numpy(state))
    ind = np.array([0, 1, 2, -1, 1, 0], np.int32)
    if grip_informed:
        ind[2] = 5
    got = env.core.set_sub_goal(state, t(ind).to(torch.int32))
    ref = jax.vmap(jenv.set_sub_goal)(jstate, jnp.asarray(ind))
    np.testing.assert_array_equal(n(got.desired_goal),
                                  np.asarray(ref.desired_goal))
    np.testing.assert_array_equal(n(got.sub_goal_ind), ind)


def _pairwise_xy(x):
    return np.linalg.norm(x[:, :, None, :2] - x[:, None, :, :2], axis=-1)


@pytest.mark.parametrize('task', ['block_rearrange', 'block_stack'])
def test_reset_invariants(task):
    count, nb = 256, 3
    env = make_vec_env(num_envs=count, task=task, num_block=nb, device='cpu',
                       seed=3, use_curriculum=True)
    core = env.core
    state, obs = env.reset()
    blocks = n(state.phys.body_pos)
    dims = {'observation': 8 + 16 * nb, 'policy_state': 4 + 3 * nb,
            'achieved_goal': 3 * nb, 'desired_goal': 3 * nb}
    assert {k: tuple(v.shape) for k, v in obs.items()} == {
        k: (count, d) for k, d in dims.items()}
    # blocks: apart, away from the gripper start, in bounds, on the table
    off = ~np.eye(nb, dtype=bool)
    assert (_pairwise_xy(blocks)[:, off] > 0.06).all()
    assert (np.linalg.norm(blocks[..., :2] - core.tip_initial[:2], axis=-1)
            > 0.06).all()
    assert (blocks[..., :2] >= core.object_lower[:2] - 1e-6).all()
    assert (blocks[..., :2] <= core.object_upper[:2] + 1e-6).all()
    np.testing.assert_allclose(blocks[..., 2], 0.175, atol=1e-7)
    np.testing.assert_array_equal(n(state.spawn_body_pos), blocks)
    targets = n(state.target_xyzs)
    assert (targets[..., :2] >= core.target_lower[:2] - 1e-6).all()
    assert (targets[..., :2] <= core.target_upper[:2] + 1e-6).all()
    to_blocks = np.linalg.norm(targets[:, :, None, :2]
                               - blocks[:, None, :, :2], axis=-1)
    level = n(state.curriculum_level)
    assert ((level >= 0) & (level < nb)).all()
    if task == 'block_rearrange':
        assert (_pairwise_xy(targets)[:, off] > 0.06).all()
        assert (to_blocks > 0.06).all()
        np.testing.assert_allclose(targets[..., 2], 0.175, atol=1e-7)
        assert (n(state.ind_block_to_move).sum(1) == level + 1).all()
    else:
        # one tower: a base > 0.08 m from every block, heights 0.175 + 0.03 k
        np.testing.assert_array_equal(targets[..., :2],
                                      targets[:, :1, :2].repeat(nb, 1))
        assert (to_blocks[:, 0] > 0.08).all()
        np.testing.assert_allclose(
            targets[..., 2], np.broadcast_to(0.175 + 0.03 * np.arange(nb),
                                             (count, nb)), atol=1e-6)
        assert (np.sort(n(state.block_order), 1) == np.arange(nb)).all()
    assert (n(state.curriculum_goal_step) == level * 25 + 50).all()
    # a reseeded reset repeats itself
    again, _ = env.reset(seed=3)
    np.testing.assert_array_equal(n(again.target_xyzs), targets)


def test_curriculum_survives_auto_reset():
    """The TimeLimit's reset keeps the curriculum bookkeeping: with updates
    on, the goal counters grow at the drawn level and the probabilities
    follow them."""
    env = make_vec_env(num_envs=2, task='block_rearrange', num_block=2,
                       device='cpu', use_curriculum=True,
                       num_goals_to_generate=8)
    state, _ = env.reset()
    prob = torch.tensor([[0.5, 0.5], [0.0, 1.0]])
    counts = torch.tensor([[1.0, 3.0], [4.0, 0.0]])
    state = state._replace(curriculum_prob=prob, goals_generated=counts,
                           curriculum_update=torch.tensor([True, False]),
                           steps=torch.full_like(state.steps, 49),
                           host_steps=49)
    state, _, _, done, _ = env.step(state, torch.zeros((2, 3)))
    assert n(done).all() and state.host_steps == 0
    level = n(state.curriculum_level)
    want = counts.clone()
    want[0, level[0]] += 1.0
    np.testing.assert_array_equal(n(state.goals_generated), n(want))
    np.testing.assert_array_equal(
        n(state.curriculum_prob)[0],
        n(multi_step.update_curriculum_prob(prob, want, 2, 4))[0])
    np.testing.assert_array_equal(n(state.curriculum_prob)[1], n(prob)[1])
    assert n(state.curriculum_update).tolist() == [True, False]
    assert (n(state.ind_block_to_move).sum(1) == level + 1).all()


def test_step_demonstrator_matches_jax():
    """The port's copy steps as the JAX package's does, through cycling,
    sticking at the final goal and both resets."""
    demos = default_demonstrations(3)
    ours, ref = StepDemonstrator(demos), JaxDemonstrator(demos)
    seq = []
    for d in (ours, ref):
        out = []
        d.manual_reset(2)
        out += [d.get_next_goal() for _ in range(5)]
        d.reset_with_the_last_sub_goal_index(1)
        out += [d.get_next_goal() for _ in range(3)] + [d.demon_ind, d.final]
        d = type(d)(demos, stick_with_final_goal=False)
        d.manual_reset(2)
        out += [d.get_next_goal() for _ in range(4)]
        seq.append(out)
    assert seq[0] == seq[1]
    assert seq[0][:5] == [0, 1, 2, 2, 2]
