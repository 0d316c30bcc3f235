"""Slide against the JAX package on the CPU: the cylinder branch of kernel
K2's plain version (`ops/engine_plain.py`) and the slide env.

- The lane geometry against `contact.cylinder_plane` and
  `contact.box_cylinder_upright` (the XLA engine's) and against the Pallas
  module's own plain-jnp tile helpers (`pallas_engine._cyl_plane_lanes`,
  `box_cyl_lanes`, called on (8, 128) tiles without `pallas_call`), at
  1e-6. The vertical lane's point is the one place where the two reference
  engines differ: the Pallas kernel puts it at the cap centre along the
  world normal, the XLA engine along the box-frame normal; the port follows
  the Pallas kernel, so that point is held against the Pallas helper, and
  against the XLA one through its world normal.
- The scene constants against the XLA engine (`dynamics.Engine`): masses,
  frictions and lane-culling masks exactly; the inverse inertia exactly as
  the Pallas kernel rounds it (1 / inertia in float64, then float32) and
  within one ulp of the XLA engine, which rounds the inertia to float32
  first.
- The whole control step against the XLA engine on slide's stress states
  (`tests/torch_common.py:slide_inputs`) at 2e-3 after 2 substeps, and
  after 100 for the coasting puck; every lane group of the scene acts in
  one of them. The XLA engine's vertical point lies on the wrong cap where
  the pad's z axis points down, as it does under the gripper (its
  `box_cylinder_upright` treats the box frame's z as the world's), and its
  friction then turns the puck the other way; so the engine traced here
  takes that point as the Pallas kernel places it, through
  `_pallas_vertical_point`, patched into its contact module for the
  fixture's trace only. Everything else in the trace is the XLA engine's
  own.
- Three steps of slide at 16 envs against the JAX package's fused-kernel
  step sequence with the XLA oracles, as `tests/test_torch_env.py:
  _jax_main_path` builds it for push, at 5e-3, from the port's reset state
  carried across in the path-keyed checkpoint format; and the reset
  invariants of the long table.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pybullet_multigoal_gym_tpu  # noqa: F401  (JAX precision config)
from pybullet_multigoal_gym_tpu.config import EnvConfig as JaxConfig
from pybullet_multigoal_gym_tpu.envs.single_step import KukaSingleStepEnv
from pybullet_multigoal_gym_tpu.ops import contact as JC
from pybullet_multigoal_gym_tpu.ops import dynamics as JD
from pybullet_multigoal_gym_tpu.ops import ik as jik
from pybullet_multigoal_gym_tpu.ops import pallas_engine as PE
from pybullet_multigoal_gym_tpu.ops import scene as JS
from pybullet_multigoal_gym_tpu_torch import make_vec_env
from pybullet_multigoal_gym_tpu_torch.interop import (state_from_numpy,
                                                      state_to_numpy)
from pybullet_multigoal_gym_tpu_torch.maths import quat as tq
from pybullet_multigoal_gym_tpu_torch.model import kuka_model as KM
from pybullet_multigoal_gym_tpu_torch.ops import dynamics as D
from pybullet_multigoal_gym_tpu_torch.ops import engine_plain as EP
from pybullet_multigoal_gym_tpu_torch.ops import scene as S
from tests.torch_common import (ARM_FIELDS, BODY_FIELDS, n, plain_run,
                                slide_inputs, t, torch_controls,
                                torch_state)

torch.set_num_threads(1)

TILE = 1024
R, HL = 0.03, 0.01                       # the puck (scene.py:117)
META = dict(body_sgn=1.0, finger_idx=0, fin_sgn=-1.0, link=6, arm_sgn=-1.0,
            couple=0.0, ee_sgn=-1.0)


def tiles(x):
    """(1024, k) numpy -> (k, 8, 128) jax tiles."""
    return jnp.asarray(np.ascontiguousarray(x.T).reshape(-1, 8, 128))


def untile(x):
    x = np.asarray(x)
    return x.reshape(x.shape[0], -1).T if x.ndim == 3 else x.reshape(-1)


def _jit_lanes(fn):
    """A Pallas lane helper jitted, returning the lanes' arrays (one
    compile instead of an eager dispatch per operation)."""
    def arrays(*args):
        return [dict(pt=l.pt, nrm=l.nrm, pen=l.pen, active=l.active)
                for l in fn(*args)]
    run = jax.jit(arrays)
    return lambda *args: [type('Lane', (), d) for d in run(*args)]


def _unit(q):
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


# ------------------------------------------------------------ lane geometry
@pytest.fixture(scope='module')
def puck_poses():
    """Seeded poses. Cylinder on the plane: a quarter upright (four rim
    points at one height), the rest tilted by up to 0.4 rad with the lowest
    rim point within 3 mm of the plane (some rim points touch, some do
    not). Pad against puck, in the pad's frame, a quarter each: the axis
    inside the pad's xy (the exit-face fallback; the lateral lane wins near
    the pad's mid-height, the vertical one toward its ends), beyond an x or
    a y face (lateral lanes), and beyond a vertical edge (diagonal
    normals)."""
    rng = np.random.default_rng(0)
    q4 = TILE // 4

    def u(lo, hi, shape):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    ang = np.concatenate([np.zeros(q4), u(0.02, 0.4, (TILE - q4,))])
    az = u(0.0, 2 * np.pi, (TILE,))
    axis = np.stack([np.cos(az), np.sin(az), np.zeros(TILE)], -1)
    bq = _unit(np.concatenate([np.cos(ang / 2)[:, None],
                               axis * np.sin(ang / 2)[:, None]], -1))
    z = 0.16 + HL * np.cos(ang) + R * np.sin(ang) + u(-0.003, 0.003, (TILE,))
    bp = np.concatenate([u(-0.6, -0.4, (TILE, 2)), z[:, None]], -1)

    hb = np.asarray(KM.FINGER_HALF_EXTENTS, np.float32)
    sgn = np.where(rng.random((TILE, 2)) < 0.5, -1.0, 1.0)
    inside = np.stack([u(-0.9, 0.9, (q4,)) * hb[0], u(-0.9, 0.9, (q4,)) * hb[1],
                       u(-0.06, 0.06, (q4,))], -1)
    face_x = np.stack([sgn[:q4, 0] * (hb[0] + R - u(-0.005, 0.01, (q4,))),
                       u(-1.5, 1.5, (q4,)) * hb[1], u(-0.045, 0.045, (q4,))], -1)
    face_y = np.stack([u(-1.2, 1.2, (q4,)) * hb[0],
                       sgn[:q4, 1] * (hb[1] + R - u(-0.005, 0.01, (q4,))),
                       u(-0.045, 0.045, (q4,))], -1)
    edge = np.stack([sgn[:q4, 0] * (hb[0] + u(0.005, 0.025, (q4,))),
                     sgn[:q4, 1] * (hb[1] + u(0.005, 0.025, (q4,))),
                     u(-0.06, 0.06, (q4,))], -1)
    local = np.concatenate([inside, face_x, face_y, edge]).astype(np.float32)
    fq = _unit(rng.normal(size=(TILE, 4)))
    fp = u(-0.6, -0.4, (TILE, 3))
    Rf = n(tq.to_matrix(t(fq)))
    cc = (fp + np.einsum('nij,nj->ni', Rf, local)).astype(np.float32)
    return dict(bp=bp.astype(np.float32), bq=bq, fp=fp, fq=fq, cc=cc,
                hb=hb)


def test_cyl_plane_lanes_match_references(puck_poses):
    g = puck_poses
    out = EP.cyl_plane_lanes(t(g['bp']), t(g['bq']), R, HL, 0.16, 0.05,
                             body_sgn=1.0)
    pts, nrm, pen, act = JC.cylinder_plane(jnp.asarray(g['bp']),
                                           jnp.asarray(g['bq']), R, HL, 0.16)
    ref = _jit_lanes(lambda bp, bq: PE._cyl_plane_lanes(
        bp, bq, R, HL, 0.16, 0.05, body_sgn=1.0))(tiles(g['bp']),
                                                   tiles(g['bq']))
    for k, lane in enumerate(out):
        for got, want in ((lane.pt, pts[:, k]), (lane.nrm, nrm[:, k]),
                          (lane.pen, pen[:, k]), (lane.active, act[:, k]),
                          (lane.pt, untile(ref[k].pt)),
                          (lane.pen, untile(ref[k].pen)),
                          (lane.active, untile(ref[k].active))):
            np.testing.assert_allclose(n(got), np.asarray(want, np.float32),
                                       atol=1e-6, err_msg='rim point %d' % k)
        assert (lane.mu, lane.body_sgn) == (0.05, 1.0)
    touching = np.stack([n(lane.active) for lane in out]).sum(0)
    # upright pucks on the plane, and tilted ones resting on part of the rim
    assert (touching == 4).any() and ((touching > 0) & (touching < 4)).any()


def test_box_cyl_lanes_match_references(puck_poses):
    g = puck_poses
    hb = tuple(float(x) for x in g['hb'])
    Rf = tq.to_matrix(t(g['fq']))
    lat, vert = EP.box_cyl_lanes(t(g['fp']), Rf, hb, t(g['cc']), R, HL, 1.0,
                                 **META)
    pts, nrm, pen, act = JC.box_cylinder_upright(
        jnp.asarray(g['fp']), jnp.asarray(g['fq']),
        jnp.broadcast_to(jnp.asarray(g['hb']), (TILE, 3)),
        jnp.asarray(g['cc']), R, HL)
    ref = _jit_lanes(lambda fp, fq, cc: PE.box_cyl_lanes(
        fp, PE.qmat(fq), hb, cc, R, HL, 1.0, **META))(
            tiles(g['fp']), tiles(g['fq']), tiles(g['cc']))
    # the Pallas helper: every field
    for lane, want in zip((lat, vert), ref):
        for f in ('pt', 'nrm', 'pen', 'active'):
            np.testing.assert_allclose(n(getattr(lane, f)),
                                       untile(getattr(want, f)), atol=1e-6,
                                       err_msg=f)
        assert lane.mu == 1.0
        for f, v in META.items():
            assert getattr(lane, f) == v, f
    # the XLA engine's contact function: penetrations, activations and
    # normals, the lateral point; the vertical point along its world normal
    for k, lane in enumerate((lat, vert)):
        np.testing.assert_allclose(n(lane.pen), np.asarray(pen[:, k]),
                                   atol=1e-6)
        np.testing.assert_array_equal(n(lane.active) > 0,
                                      np.asarray(act[:, k]))
        np.testing.assert_allclose(n(lane.nrm), np.asarray(nrm[:, k]),
                                   atol=1e-6)
    np.testing.assert_allclose(n(lat.pt), np.asarray(pts[:, 0]), atol=1e-6)
    np.testing.assert_allclose(
        n(vert.pt), g['cc'] - np.asarray(nrm[:, 1]) * np.float32(HL),
        atol=1e-6)
    # the cases: the axis inside the pad (the exit-face fallback), with the
    # lateral lane and with the vertical lane winning, and lanes of both
    # kinds acting
    q4 = TILE // 4
    inside_lat = n(lat.active)[:q4] > 0
    inside_vert = n(vert.active)[:q4] > 0
    assert inside_lat.sum() > 10 and inside_vert.sum() > 10
    assert not (inside_lat & inside_vert).any()
    assert (n(lat.active)[q4:] > 0).sum() > 100
    # a lateral normal leaving an inside axis lies along a pad face
    nl = np.einsum('nji,nj->ni', n(Rf)[:q4], n(lat.nrm)[:q4])[inside_lat]
    np.testing.assert_allclose(np.abs(nl).max(1), 1.0, atol=1e-6)


# --------------------------------------------------------- scene constants
@pytest.mark.parametrize('ik_workspace', [True, False])
def test_slide_scene_consts_match_xla(ik_workspace):
    spec = S.single_step_scene(True, 'long_table')
    sc = D.scene_consts(spec, ik_workspace=ik_workspace)
    eng = JD.Engine(JS.single_step_scene(True, 'long_table'),
                    ik_workspace=ik_workspace)
    assert sc.geom_type == S.CYLINDER and eng.geom_type[0] == JS.CYLINDER
    assert np.float32(sc.inv_mass) == eng.body_inv_mass[0]
    # the Pallas kernel's constants (pallas_engine.py:506-513)
    a = JS.single_step_scene(True, 'long_table').np_arrays()
    pallas = (1.0 / JS.body_inertia_diag(
        float(a['body_mass'][0]), tuple(float(x) for x in a['geom_half'][0]),
        int(a['geom_type'][0]))).astype(np.float32)
    np.testing.assert_array_equal(np.float32(sc.inv_inertia), pallas)
    np.testing.assert_array_max_ulp(np.float32(sc.inv_inertia),
                                    eng.body_inv_inertia[0], maxulp=1)
    fr = {p['kind']: np.float32(p['friction']) for p in eng.plan}
    assert np.float32(sc.plane_mu) == fr['plane'] == np.float32(0.05)
    assert np.float32(sc.finger_mu) == fr['finger_geom'] == 1.0
    assert np.float32(sc.plane_friction) == fr['finger_plane']
    assert np.float32(0.5 * sc.plane_friction) == fr['arm_plane']
    assert np.float32(0.5 * sc.body_friction) == fr['arm_geom']
    spheres = {k: sum(1 << p['sphere'] for p in eng.plan if p['kind'] == k)
               for k in ('arm_plane', 'arm_geom')}
    assert (sc.plane_mask, sc.geom_mask) == (spheres['arm_plane'],
                                             spheres['arm_geom'])
    # 21 lanes under EE control, 30 under joint control: rim 4, pads 2 x 2,
    # finger-plane 2 x 4, and the arm spheres' plane and puck lanes
    st = torch_state(slide_inputs('drop', 2)[0])
    lanes = EP.build_lanes(sc, EP.fk_chain(st.q, st.fq), st.body_pos[:, 0],
                           st.body_quat[:, 0], EP.qmat(st.body_quat[:, 0]))
    assert len(lanes) == eng.n_contacts == (21 if ik_workspace else 30)


# ---------------------------------------------------------- control step
# (control, states): slide under EE control, the main path, and under joint
# control, which keeps every arm-sphere lane (the puck seen as a box)
SCENES = {'ee': ('drop', 'tilt', 'strike', 'cap', 'coast'),
          'joint': ('sphere',)}
CASES = [(control, kind, n_sub) for control in sorted(SCENES)
         for kind in SCENES[control]
         for n_sub in ((2, 100) if kind == 'coast' else (2,))]
N_STATE = 16
GROUPS = ('cyl-plane', 'finger-cyl lateral', 'finger-cyl vertical',
          'finger-plane', 'sphere-box', 'sphere-plane')


def _pallas_vertical_point(box_cylinder_upright):
    """`contact.box_cylinder_upright` with the vertical lane's point at the
    cap centre along the lane's world normal (`pallas_engine.py:486-487`)
    instead of along the box-frame normal (`contact.py:424`)."""
    def fn(cb, qb, hb, cc, radius, half_len):
        pts, nrm, pen, act = box_cylinder_upright(cb, qb, hb, cc, radius,
                                                  half_len)
        pts = pts.at[..., 1, :].set(cc - nrm[..., 1, :] * half_len)
        return pts, nrm, pen, act
    return fn


def _xla_slide(control):
    """The XLA engine's substep loop for slide under ``control``, jitted
    (a traced trip count) and traced once at 16 envs with the vertical
    lane's point of the Pallas kernel; and its state after 2 and 100
    substeps from each of the scene's states."""
    eng = JD.Engine(JS.single_step_scene(True, 'long_table'),
                    ik_workspace=control == 'ee')
    run = jax.jit(jax.vmap(
        lambda s, c, k: jax.lax.fori_loop(
            0, k, lambda i, x: eng.substep(x, c), s), in_axes=(0, 0, None)))
    ref = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JC, 'box_cylinder_upright',
                   _pallas_vertical_point(JC.box_cylinder_upright))
        for kind in SCENES[control]:
            st, ctl = slide_inputs(kind, N_STATE)
            jst = JD.PhysicsState(**{k: jnp.asarray(v)
                                     for k, v in st.items()})
            jctl = JD.Controls(**{k: jnp.asarray(v) for k, v in ctl.items()})
            subs = (2, 100) if kind == 'coast' else (2,)
            ref[kind] = st, ctl, {k: run(jst, jctl, k) for k in subs}
    return ref, run


@pytest.fixture(scope='module')
def xla_slide_ee():
    return _xla_slide('ee')


@pytest.fixture(scope='module')
def xla_slide(request):
    """One control's references (`_xla_slide`), one compile per scene."""
    control = request.param
    if control == 'ee':
        return control, request.getfixturevalue('xla_slide_ee')[0]
    return control, _xla_slide(control)[0]


@pytest.mark.parametrize('xla_slide,kind,n_sub', CASES,
                         indirect=['xla_slide'], scope='module')
def test_slide_control_step_plain_matches_xla(xla_slide, kind, n_sub):
    control, ref = xla_slide
    st, ctl, out_ref = ref[kind]
    sc = D.scene_consts(S.single_step_scene(True, 'long_table'),
                        ik_workspace=control == 'ee')
    out = EP.control_step(sc, torch_state(st), torch_controls(ctl), n_sub)
    for f in ARM_FIELDS + BODY_FIELDS:
        np.testing.assert_allclose(n(getattr(out, f)),
                                   n(getattr(out_ref[n_sub], f)), atol=2e-3,
                                   err_msg=f)
    np.testing.assert_allclose(n(out.ee_contact_force),
                               n(out_ref[n_sub].ee_contact_force),
                               atol=2e-3 / D.DT_SUB)
    if kind == 'coast':
        # the puck slid and slowed on mu = 0.05 (0.49 m/s^2)
        v0 = np.linalg.norm(st['body_linvel'][:, 0, :2], axis=-1)
        v = np.linalg.norm(n(out.body_linvel)[:, 0, :2], axis=-1)
        assert (v < v0).all() and (v > 0.5 * v0).all()


def test_slide_states_act_every_lane_group():
    """Each lane group of slide's scenes acts, within 2 substeps, in some
    env of one of the states above; and each of the cylinder's groups in
    the state made for it."""
    shares = {}
    for control, kinds in SCENES.items():
        sc = D.scene_consts(S.single_step_scene(True, 'long_table'),
                            ik_workspace=control == 'ee')
        for kind in kinds:
            st, ctl = slide_inputs(kind, N_STATE)
            shares[kind] = plain_run(sc, torch_state(st),
                                     torch_controls(ctl), 2)[1]
    assert sorted(shares['sphere']) == sorted(GROUPS)
    assert all(max(s[g] for s in shares.values()) > 0 for g in GROUPS)
    for kind, group in (('tilt', 'cyl-plane'), ('strike', 'finger-cyl lateral'),
                        ('cap', 'finger-cyl vertical'),
                        ('sphere', 'sphere-box')):
        assert shares[kind][group] > 0.25, (kind, shares[kind])


# --------------------------------------------------------------- the env
N_STEPS = 3


def _jax_env_state(env, leaves, keys):
    """The JAX package's `EnvState` for the port's state leaves
    (`interop.state_to_numpy`), its structure from `reset` traced once
    (`jax.eval_shape`, nothing compiled), ``keys`` the per-env PRNG keys."""
    like = jax.eval_shape(jax.vmap(env.reset), keys)[0]
    return jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(
            keys if jax.tree_util.keystr(path) == '.key'
            else leaves[jax.tree_util.keystr(path)], x.dtype), like)


@pytest.fixture(scope='module')
def slide_run(xla_slide_ee):
    """The port's reset state at 16 envs (its leaves), seeded actions, and
    the JAX package's main-path outputs after each of 3 steps: the step
    sequence of its fused-kernel path (`envs/vec_env.py`, as
    `tests/test_torch_env.py:_jax_main_path` builds it), vmapped
    ``step_decode_pre`` -> ``ik.solve(num_iters=8)`` -> 100 x
    ``Engine.substep`` (the control-step fixture's compiled program) ->
    ``step_finish``."""
    jenv = KukaSingleStepEnv(JaxConfig(task='slide'))
    run = xla_slide_ee[1]
    env = make_vec_env(num_envs=N_STATE, task='slide', device='cpu', seed=1)
    leaves = state_to_numpy(env.reset()[0])
    state = _jax_env_state(jenv, leaves,
                           jax.random.split(jax.random.PRNGKey(1), N_STATE))
    rest = jnp.asarray(jenv.rest_pose)
    decode = jax.jit(jax.vmap(jenv.step_decode_pre))
    solve = jax.jit(jax.vmap(lambda tgt, q: jik.solve(
        tgt, q_init=q, rest_pose=rest, num_iters=8)))
    finish = jax.jit(jax.vmap(jenv.step_finish))
    rng = np.random.default_rng(1)
    actions = rng.uniform(-1, 1, (N_STEPS, N_STATE, jenv.cfg.action_dim)
                          ).astype(np.float32)
    zeros = jnp.zeros((N_STATE,), jnp.float32)
    outs = []
    for a in actions:
        state, f_t = decode(state, jnp.asarray(a))
        q_t = solve(state.ee_target, state.phys.q)
        phys = run(state.phys, JD.Controls(
            q_target=q_t, f_target=f_t, door_motor_on=zeros > 0,
            door_target=zeros), 100)
        state = state._replace(phys=phys, steps=state.steps + 1)
        state, obs, reward, _ = finish(state)
        done = state.steps >= jenv.cfg.max_episode_steps
        outs.append(jax.tree_util.tree_map(np.asarray, (obs, reward, done)))
    return jenv, leaves, actions, outs


def test_slide_main_path_matches_jax(slide_run):
    jenv, leaves, actions, outs = slide_run
    env = make_vec_env(num_envs=N_STATE, task='slide', device='cpu')
    assert env.core.scene.geom_type == S.CYLINDER
    for attr in ('target_lower', 'target_upper', 'object_lower',
                 'object_upper', 'block_z'):
        np.testing.assert_allclose(getattr(env.core, attr),
                                   getattr(jenv, attr), err_msg=attr)
    np.testing.assert_allclose(env.core.rest_pose, jenv.rest_pose, atol=1e-5)
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


def test_slide_reset_invariants():
    """The long table: goals drawn 0.4 m further out in x than the other
    tasks', beyond the end effector's reach, on the table at the puck's
    height (0.170, where the block rests at 0.175); the puck upright and
    at rest on the table, 0.1 m or more from the gripper (as far as the
    reference's sampler gets it there)."""
    count = 256
    env = make_vec_env(num_envs=count, task='slide', device='cpu', seed=3)
    core = env.core
    state, obs = env.reset()
    assert core.block_z == pytest.approx(0.170)
    np.testing.assert_allclose(core.target_lower[:2], [-1.09, -0.2],
                               atol=1e-9)
    np.testing.assert_allclose(core.target_upper[:2], [-0.75, 0.2],
                               atol=1e-9)
    goal = n(state.desired_goal)
    assert (goal[:, :2] >= core.target_lower[:2] - 1e-6).all()
    assert (goal[:, :2] <= core.target_upper[:2] + 1e-6).all()
    assert (goal[:, 0] < core.ee_lower[0]).all()
    np.testing.assert_allclose(goal[:, 2], 0.170, atol=1e-7)
    puck = n(state.phys.body_pos[:, 0])
    np.testing.assert_allclose(puck[:, 2], 0.170, atol=1e-7)
    assert (puck[:, :2] >= core.object_lower[:2] - 1e-6).all()
    assert (puck[:, :2] <= core.object_upper[:2] + 1e-6).all()
    # the puck's range (0.1 about the tip, less 0.03 in x) lies mostly
    # inside the 0.1 m circle, so in a few per cent of resets all 24 draws
    # of the JAX package's fixed-trip sampler (`core.rejection_uniform`)
    # fall inside it and the last one stands
    far = np.linalg.norm(puck[:, :2] - core.tip_initial[:2], axis=-1) > 0.1
    assert far.mean() > 0.9, far.mean()
    np.testing.assert_array_equal(n(state.phys.body_quat[:, 0]),
                                  np.tile([1.0, 0, 0, 0], (count, 1)))
    assert {k: tuple(v.shape) for k, v in obs.items()} == {
        'observation': (count, 20), 'policy_state': (count, 7),
        'achieved_goal': (count, 3), 'desired_goal': (count, 3)}


def test_slide_joint_control_reset_and_step():
    """Under joint control (the scripted strike's mode) all arm-sphere lanes
    stay: one reset and one step, the arm moving toward its new joint
    target and the resting puck staying on the table."""
    env = make_vec_env(num_envs=2, task='slide', joint_control=True,
                       device='cpu', seed=4)
    assert (env.core.scene.plane_mask, env.core.scene.geom_mask) == (
        0x7f, 0x7f)
    state, obs = env.reset()
    assert tuple(obs['observation'].shape) == (2, 27)
    assert env.action_space.shape == (7,)         # no grasping in slide
    action = torch.tensor([[2.0, -1.0, 0.5, 0.0, 0.25, -0.5, 1.0]] * 2)
    new, obs, reward, done, _ = env.step(state, action)
    np.testing.assert_allclose(
        n(new.joint_target),
        n(state.joint_target + 0.05 * action.clamp(-1.0, 1.0)), atol=1e-7)
    np.testing.assert_array_equal(n(obs['observation'][:, :7]), n(new.phys.q))
    # the joints given a full step moved toward it (the pads start on the
    # table, and its lanes push back on the smaller steps)
    moved = n(new.phys.q - state.phys.q) * n(action)
    assert (moved[:, [0, 1, 6]] > 0).all()
    np.testing.assert_allclose(n(new.phys.body_pos[:, 0]),
                               n(state.phys.body_pos[:, 0]), atol=1e-4)
    assert np.isfinite(n(obs['observation'])).all()
    assert not n(done).any()
