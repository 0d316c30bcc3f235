"""Kernel K2's plain version (`ops/engine_plain.py`) against the JAX package:
the lane builders against the Pallas module's own plain-jnp tile helpers
(called directly on (8, 128) tiles, no `pallas_call`), and the whole control
step against the XLA engine (`ops/dynamics.py:Engine.substep`). K2 against
its plain version on the card: tests/test_torch_kernels.py.

Tolerances: 1e-5 for the lane geometry (the same float32 formulas), 2e-3 for
the state after 2 and 100 substeps, the bound the JAX package holds its Pallas
engine to against the XLA engine (tests/test_pallas_engine.py); the EE contact
force is an impulse over dt = 2 ms, so the same bound scaled by 1/dt.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pybullet_multigoal_gym_tpu  # noqa: F401  (JAX precision config)
from pybullet_multigoal_gym_tpu.ops import dynamics as JD
from pybullet_multigoal_gym_tpu.ops import pallas_engine as PE
from pybullet_multigoal_gym_tpu.ops import scene as JS
from pybullet_multigoal_gym_tpu_torch.maths import quat as tq
from pybullet_multigoal_gym_tpu_torch.model import kuka_model as KM
from pybullet_multigoal_gym_tpu_torch.ops import dynamics as D
from pybullet_multigoal_gym_tpu_torch.ops import cuda_engine
from pybullet_multigoal_gym_tpu_torch.ops import engine_plain as EP
from pybullet_multigoal_gym_tpu_torch.ops import scene as S
from pybullet_multigoal_gym_tpu_torch.ops.cuda_engine import CudaEngine
from tests.torch_common import (ARM_FIELDS, BODY_FIELDS, inputs, mk_controls,
                                mk_state, n, t, torch_controls, torch_state)

torch.set_num_threads(1)

TILE = 1024
META = dict(body_sgn=1.0, finger_idx=1, fin_sgn=-1.0, link=6, arm_sgn=-1.0,
            couple=0.0, ee_sgn=-1.0)


def tiles(x):
    """(1024, k) numpy -> (k, 8, 128) jax tiles."""
    return jnp.asarray(np.ascontiguousarray(x.T).reshape(-1, 8, 128))


def untile(x):
    """(k, 8, 128) tiles -> (1024, k) numpy."""
    x = np.asarray(x)
    return x.reshape(x.shape[0], -1).T if x.ndim == 3 else x.reshape(-1)


def _unit_quats(rng, count):
    q = rng.normal(size=(count, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.fixture(scope='module')
def geometry():
    """A box near a finger pad (overlapping in about half the envs), arm
    spheres around it, random orientations."""
    rng = np.random.default_rng(0)
    bp = (np.array([-0.5, 0.0, 0.18]) + rng.uniform(-0.02, 0.02, (TILE, 3))
          ).astype(np.float32)
    fp = (bp + rng.uniform(-0.04, 0.04, (TILE, 3))).astype(np.float32)
    sp = (bp + rng.uniform(-0.07, 0.07, (TILE, 3))).astype(np.float32)
    return dict(bp=bp, bq=_unit_quats(rng, TILE), fp=fp,
                fq=_unit_quats(rng, TILE), sp=sp,
                q=rng.uniform(KM.JOINT_LIMIT_LOWER, KM.JOINT_LIMIT_UPPER,
                              (TILE, 7)).astype(np.float32),
                fing=rng.uniform(-KM.FINGER_LIMIT, KM.FINGER_LIMIT,
                                 (TILE, 2)).astype(np.float32))


def _compare_lanes(ref, out):
    assert len(ref) == len(out)
    for i, (a, b) in enumerate(zip(ref, out)):
        for f in ('pt', 'nrm', 'pen', 'active'):
            np.testing.assert_allclose(n(getattr(b, f)),
                                       untile(getattr(a, f)), atol=1e-5,
                                       err_msg='lane %d %s' % (i, f))
        for f in ('mu', 'body_sgn', 'finger_idx', 'fin_sgn', 'link',
                  'arm_sgn', 'couple', 'ee_sgn'):
            assert getattr(a, f) == pytest.approx(getattr(b, f)), (i, f)


def test_fk_chain_matches_tiles(geometry):
    g = geometry
    ref = PE.fk_chain(tiles(g['q']), tiles(g['fing']))
    out = EP.fk_chain(t(g['q']), t(g['fing']))
    for j in range(7):
        np.testing.assert_allclose(n(out['o'][:, j]), untile(ref['o'][j]),
                                   atol=1e-5)
        np.testing.assert_allclose(n(out['z'][:, j]), untile(ref['z'][j]),
                                   atol=1e-5)
        np.testing.assert_allclose(n(out['spheres'][:, j]),
                                   untile(ref['spheres'][j]), atol=1e-5)
    np.testing.assert_allclose(n(out['r7']), untile(ref['r7']), atol=1e-5)
    np.testing.assert_allclose(n(out['gbase']), untile(ref['gbase']),
                               atol=1e-5)
    for f in range(2):
        np.testing.assert_allclose(n(out['fpos'][:, f]), untile(ref['fpos'][f]),
                                   atol=1e-5)
        np.testing.assert_allclose(n(out['faxis'][:, f]),
                                   untile(ref['faxis'][f]), atol=1e-5)


def test_box_plane_lanes_match_tiles(geometry):
    g = geometry
    half = (0.025, 0.025, 0.025)
    ref = PE._box_plane_lanes(tiles(g['bp']), tiles(g['bq']), half, 0.16, 0.1,
                              **META)
    out = EP.box_plane_lanes(t(g['bp']), t(g['bq']), half, 0.16, 0.1, **META)
    _compare_lanes(ref, out)


def test_sat_box_box_lanes_match_tiles(geometry):
    g = geometry
    ha, hb = (0.025, 0.025, 0.025), D.finger_consts('parallel_jaw').half
    ref = PE.sat_box_box_lanes(
        tiles(g['bp']), PE.qmat(tiles(g['bq'])), ha, tiles(g['fp']),
        PE.qmat(tiles(g['fq'])), hb, 1.0, **META)
    out = EP.sat_box_box_lanes(
        t(g['bp']), tq.to_matrix(t(g['bq'])), ha, t(g['fp']),
        tq.to_matrix(t(g['fq'])), hb, 1.0, **META)
    _compare_lanes(ref, out)
    # the inputs reach every branch: corner contacts and the cross fallback
    act = np.stack([n(l.active) for l in out])
    assert act[:8].sum() > 0 and act[8].sum() > 0


def test_sphere_lanes_match_tiles(geometry):
    g = geometry
    meta = dict(body_sgn=-1.0, link=5, arm_sgn=1.0, couple=1.0, ee_sgn=0.0)
    ref = PE.sphere_plane_lane(tiles(g['sp']), 0.043, 0.16, 0.05, **meta)
    out = EP.sphere_plane_lane(t(g['sp']), 0.043, 0.16, 0.05, **meta)
    _compare_lanes(ref, out)
    half = (0.025, 0.025, 0.025)
    ref = PE.sphere_box_lane(tiles(g['sp']), 0.043, tiles(g['bp']),
                             PE.qmat(tiles(g['bq'])), half, 0.5, **meta)
    out = EP.sphere_box_lane(t(g['sp']), 0.043, t(g['bp']),
                             tq.to_matrix(t(g['bq'])), half, 0.5, **meta)
    _compare_lanes(ref, out)
    assert n(out[0].active).sum() > 0


# ------------------------------------------------------------- control step
SUBSTEPS = (2, 100)


# (has_obj, ik_workspace, states): the scenes of EE control (the main path)
# and push under joint control, which keeps every arm-sphere lane (spheres
# on links 3-5 couple fewer joints). The 'drop' state is the JAX package's
# own; it holds the arm still, so only push, whose box falls, runs it.
SCENES = {'push': (True, True, ('drop', 'contact')),
          'reach': (False, True, ('contact',)),
          'push-joint': (True, False, ('contact',))}
# one list, grouped by scene, so that each scene's XLA reference is built once
CASES = [(scene, kind, n_sub) for scene in sorted(SCENES)
         for kind in SCENES[scene][2] for n_sub in SUBSTEPS]


@pytest.fixture(scope='module')
def xla_reference(request):
    """The XLA engine's state after 2 and after 100 substeps, 16 envs, from
    the JAX package's own test state ('drop') and from a contact-rich one."""
    has_obj, ik_workspace, kinds = SCENES[request.param]
    eng = JD.Engine(JS.single_step_scene(has_obj), ik_workspace=ik_workspace)
    # one program for every substep count (a traced trip count)
    run = jax.jit(jax.vmap(
        lambda s, c, k: jax.lax.fori_loop(
            0, k, lambda i, x: eng.substep(x, c), s), in_axes=(0, 0, None)))
    ref = {}
    for kind in kinds:
        st, ctl = inputs(has_obj, kind, 16)
        jst = JD.PhysicsState(**{k: jnp.asarray(v) for k, v in st.items()})
        jctl = JD.Controls(**{k: jnp.asarray(v) for k, v in ctl.items()})
        ref[kind] = st, ctl, {k: run(jst, jctl, k) for k in SUBSTEPS}
    return request.param, ref


@pytest.mark.parametrize('xla_reference,kind,n_sub', CASES,
                         indirect=['xla_reference'], scope='module')
def test_control_step_plain_matches_xla(xla_reference, kind, n_sub):
    task, ref = xla_reference
    st, ctl, out_ref = ref[kind]
    has_obj, ik_workspace, _ = SCENES[task]
    sc = D.scene_consts(S.single_step_scene(has_obj), ik_workspace=ik_workspace)
    out = EP.control_step(sc, torch_state(st), torch_controls(ctl), n_sub)
    fields = ARM_FIELDS + (BODY_FIELDS if has_obj else ())
    for f in fields:
        np.testing.assert_allclose(n(getattr(out, f)),
                                   n(getattr(out_ref[n_sub], f)), atol=2e-3,
                                   err_msg=f)
    np.testing.assert_allclose(n(out.ee_contact_force),
                               n(out_ref[n_sub].ee_contact_force),
                               atol=2e-3 / D.DT_SUB)
    if kind == 'contact':
        assert np.abs(n(out.ee_contact_force)).max() > 1.0


def test_scene_lane_counts():
    """33 lanes for push (box-plane 4, finger-box 2 x 9, finger-plane 2 x 4,
    arm spheres 3) and 9 for reach, with the group bounds of the Pallas
    kernel: arm-velocity lanes from the finger-box lanes on, arm-yielding
    lanes from the finger-plane lanes on. Joint control keeps all 7 sphere
    lanes on the plane and, for push, on the box."""
    for has_obj, ws, L, n_link, n_cpl in ((True, True, 33, 4, 22),
                                          (False, True, 9, 0, 0),
                                          (True, False, 44, 4, 22),
                                          (False, False, 15, 0, 0)):
        sc = D.scene_consts(S.single_step_scene(has_obj), ik_workspace=ws)
        st = torch_state(mk_state(has_obj, 2))
        ch = EP.fk_chain(st.q, st.fq)
        Ra = tq.to_matrix(st.body_quat[:, 0]) if has_obj else None
        lanes = EP.build_lanes(sc, ch, st.body_pos[:, 0], st.body_quat[:, 0],
                               Ra)
        m = EP.lane_meta(lanes, st.q)
        assert (m['L'], m['n_link'], m['n_cpl']) == (L, n_link, n_cpl)


def test_engine_wrapper_devices():
    """CPU tensors run the plain version; other non-CUDA devices raise."""
    sc = D.scene_consts(S.single_step_scene(True))
    w = CudaEngine(sc)
    st, ctl = torch_state(mk_state(True, 2)), torch_controls(mk_controls(2))
    out = w.control_step(st, ctl, n_substeps=1)
    ref = EP.control_step(sc, st, ctl, 1)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(n(a), n(b))
    meta = D.PhysicsState(*[x.to('meta') for x in st])
    with pytest.raises(ValueError):
        w.control_step(meta, ctl, n_substeps=1)
    # the raw launch takes CUDA memory only
    rows, ctl_rows = cuda_engine.pack(st, ctl)
    with pytest.raises(ValueError, match='CUDA memory'):
        w.launch(rows, ctl_rows, torch.empty_like(rows), 1)
    assert w.launches == 0
    # the kernel's layout carries the state there and back
    for a, b in zip(cuda_engine.unpack(rows, st), st):
        np.testing.assert_array_equal(n(a), n(b))
