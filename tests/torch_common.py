"""Helpers shared by the port's tests (tests/test_torch_*.py). Imports no
JAX, so that the card-only tests run where JAX is not installed."""

import functools

import numpy as np
import pytest
import torch

from pybullet_multigoal_gym_tpu_torch.model import kuka_model as KM
from pybullet_multigoal_gym_tpu_torch.ops import dynamics as D
from pybullet_multigoal_gym_tpu_torch.ops import engine_plain as EP
from pybullet_multigoal_gym_tpu_torch.ops import multibody_plain as MP
from pybullet_multigoal_gym_tpu_torch.ops import scene as S

ARM_FIELDS = ('q', 'qd', 'fq', 'fqd')
BODY_FIELDS = ('body_pos', 'body_quat', 'body_linvel', 'body_angvel')


@pytest.fixture
def cuda():
    """The CUDA device; skips where there is none (the kernels have no CPU
    mode, so their tests run only on a machine with a card)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the hand-written kernels run only '
                    'on the card')
    return torch.device('cuda')


def t(x, device='cpu'):
    """numpy -> float32 torch tensor."""
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def n(x):
    """torch / jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def workspace_targets(rng, count):
    """Tip targets from the IK workspace box of the JAX package's own IK
    test (tests/test_pallas_engine.py)."""
    return rng.uniform([-0.62, -0.15, 0.2], [-0.42, 0.15, 0.45],
                       (count, 3)).astype(np.float32)


def mk_state(has_obj, count, seed=0, z=0.21):
    """The state of tests/test_pallas_engine.py: rest pose, fingers at 0, a
    box dropped near the fingers (numpy leaves, (count, ...))."""
    rng = np.random.default_rng(seed)
    bp = (np.array([[-0.5, 0.05, z]]) + rng.uniform(-0.02, 0.02, (count, 1, 3))
          ).astype(np.float32)
    if not has_obj:
        bp = np.zeros((count, 1, 3), np.float32)
    z3 = np.zeros((count, 1, 3), np.float32)
    return dict(
        q=np.tile(np.asarray(KM.KUKA_REST_POSE, np.float32), (count, 1)),
        qd=np.zeros((count, 7), np.float32), fq=np.zeros((count, 2), np.float32),
        fqd=np.zeros((count, 2), np.float32), body_pos=bp,
        body_quat=np.tile(np.array([[[1.0, 0, 0, 0]]], np.float32),
                          (count, 1, 1)),
        body_linvel=z3, body_angvel=z3, door_q=np.zeros(count, np.float32),
        door_qd=np.zeros(count, np.float32),
        ee_contact_force=np.zeros((count, 3), np.float32))


# IK solution for the tip at (-0.52, 0, 0.175): finger pads 15 mm above the
# table plane
_Q_LOW = np.array([0.0, -0.6859, 0.0, 1.7677, 0.0, -0.688, 0.0], np.float32)


def mk_contact_state(has_obj, count, seed=0):
    """A moving arm low over the table with the box between the finger pads:
    finger-box, finger-plane and arm-sphere lanes are active in many envs,
    so the solve, the finger and arm coupling and the EE force all act."""
    rng = np.random.default_rng(seed)

    def u(lo, hi, shape):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    st = mk_state(has_obj, count, seed)
    st.update(q=_Q_LOW + u(-0.03, 0.03, (count, 7)), qd=u(-0.2, 0.2, (count, 7)),
              fq=u(0.0, 0.035, (count, 2)), fqd=u(-0.05, 0.05, (count, 2)))
    if has_obj:
        bq = np.concatenate([np.ones((count, 1, 1), np.float32),
                             u(-0.1, 0.1, (count, 1, 3))], -1)
        st.update(body_pos=(np.array([[-0.52, 0.0, 0.185]], np.float32)
                            + u(-0.01, 0.01, (count, 1, 3))),
                  body_quat=bq / np.linalg.norm(bq, axis=-1, keepdims=True),
                  body_linvel=u(-0.05, 0.05, (count, 1, 3)))
    return st


def mk_controls(count, state=None, seed=0):
    """Hold the rest pose with the fingers closing; with ``state``, servo
    toward a target near the state's configuration instead."""
    rng = np.random.default_rng(seed + 1)
    qt = np.tile(np.asarray(KM.KUKA_REST_POSE, np.float32), (count, 1))
    ft = np.full((count, 2), 0.035, np.float32)
    if state is not None:
        qt = state['q'] + rng.uniform(-0.05, 0.05, (count, 7)).astype(np.float32)
        ft = rng.uniform(-0.035, 0.035, (count, 2)).astype(np.float32)
    return dict(
        q_target=qt, f_target=ft,
        door_motor_on=np.zeros(count, bool),
        door_target=np.zeros(count, np.float32))


def torch_state(d, device='cpu'):
    return D.PhysicsState(**{k: torch.as_tensor(v, device=device)
                             for k, v in d.items()})


def torch_controls(d, device='cpu'):
    return D.Controls(**{k: torch.as_tensor(v, device=device)
                         for k, v in d.items()})


def sphere_plane_q(count, seed=0):
    """Arm configurations (numpy, (count, 7)) that lower a wrist or elbow
    collision sphere (links 3-5) onto the table plane (z 0.16): drawn around
    the rest pose within the joint limits, kept where such a sphere reaches
    up to 3 mm into the plane while the finger pads stay above it."""
    keep = _sphere_plane_configs(seed)
    return keep[np.arange(count) % len(keep)]


@functools.lru_cache(maxsize=None)
def _sphere_plane_configs(seed, plane_z=0.16):
    rng = np.random.default_rng(seed)
    lo = np.asarray(KM.JOINT_LIMIT_LOWER, np.float32)
    hi = np.asarray(KM.JOINT_LIMIT_UPPER, np.float32)
    cand = np.clip(np.asarray(KM.KUKA_REST_POSE, np.float32)
                   + rng.uniform(-1.6, 1.6, (16384, 7)).astype(np.float32),
                   lo, hi)
    ch = EP.fk_chain(t(cand), torch.zeros((len(cand), 2)))
    radius = np.asarray(KM.ARM_SPHERE_RADIUS, np.float32)
    pen = plane_z + radius - n(ch['spheres'])[..., 2]         # (M, 7)
    low = (np.asarray(KM.ARM_SPHERE_LINK) < 6)
    touch = ((pen[:, low] > 0.0) & (pen[:, low] < 0.003)).any(1)
    clear = (n(ch['fpos'])[..., 2] > plane_z + 0.06).all(1)
    keep = cand[touch & clear]
    assert len(keep) >= 16, len(keep)
    return keep


def sphere_inputs(st, count, seed):
    """``st`` with a wrist or elbow sphere resting on the table
    (sphere_plane_q), the arm moving slowly and servoing to within 0.01 rad
    of where it is, and its controls."""
    rng = np.random.default_rng(seed + 2)
    st.update(q=sphere_plane_q(count, seed),
              qd=rng.uniform(-0.02, 0.02, (count, 7)).astype(np.float32))
    ctl = mk_controls(count)
    ctl.update(q_target=st['q'] + rng.uniform(-0.01, 0.01, (count, 7))
               .astype(np.float32), f_target=st['fq'].copy())
    return st, ctl


def inputs(has_obj, kind, count, seed=0):
    """Physics state and controls (numpy): 'drop' (the JAX package's test
    state), 'contact' (mk_contact_state) or 'sphere' (a wrist or elbow
    sphere on the table: sphere_inputs)."""
    if kind == 'drop':
        return mk_state(has_obj, count, seed), mk_controls(count)
    if kind == 'sphere':
        return sphere_inputs(mk_state(has_obj, count, seed), count, seed)
    st = mk_contact_state(has_obj, count, seed)
    return st, mk_controls(count, st, seed)


SLIDE_KINDS = ('drop', 'tilt', 'strike', 'cap', 'coast', 'sphere')
_PUCK_R, _PUCK_HL, _PUCK_Z = 0.03, 0.01, 0.170


@functools.lru_cache(maxsize=None)
def _q_cap():
    """An IK solution (numpy, (7,)) for the tip at (-0.52, 0, 0.179): the
    finger pads' centres 0.05 m above a resting puck's centre, their
    bottoms 1 mm under its cap."""
    from pybullet_multigoal_gym_tpu_torch.ops import ik
    return n(ik.solve(torch.tensor([-0.52, 0.0, 0.179]),
                      q_init=torch.as_tensor(_Q_LOW)))


def _beside_pad(st, rng, count, local):
    """Puck positions (count, 1, 3) at ``local`` (count, 3) in the frame of
    a finger pad drawn per env (the pad's rotation is link 7's)."""
    ch = EP.fk_chain(t(st['q']), t(st['fq']))
    f = rng.integers(0, 2, count)
    pad = n(ch['fpos'])[np.arange(count), f]
    R = n(EP.qmat(ch['r7']))
    return (pad + np.einsum('nij,nj->ni', R, local)).astype(np.float32)[:, None]


def slide_inputs(kind, count, seed=0):
    """Physics state and controls (numpy) for slide's scene, the puck a
    cylinder of radius 0.03 and half length 0.01 on the long table:
    'drop' (the JAX package's own drop state, mk_state), 'tilt' (the puck
    tilted by up to 0.3 rad and lowered until one to three rim points touch
    the table), 'strike' (the arm low and moving, the puck beside a finger
    pad in the pad's frame, up to 3 mm into it and sliding toward it:
    lateral finger-cylinder lanes), 'cap' (a pad's bottom up to 2 mm into
    the resting puck's cap: vertical lanes), 'coast' (the puck sliding at
    1.5 m/s over the mu = 0.05 table, the arm at rest) and 'sphere' (joint
    control: a wrist or elbow sphere on the puck's cap, which the spheres
    see as a box)."""
    rng = np.random.default_rng(seed)

    def u(lo, hi, shape):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    st = mk_state(True, count, seed)
    if kind == 'drop':
        return st, mk_controls(count)
    ctl = mk_controls(count)
    rest_xy = np.array([-0.5, 0.05], np.float32) + u(-0.02, 0.02, (count, 2))
    if kind == 'tilt':
        # rotate about a horizontal axis, then set the centre so that the
        # lowest rim point lies 0-2 mm under the plane
        ang = u(0.05, 0.3, (count,))
        az = u(0.0, 2 * np.pi, (count,))
        axis = np.stack([np.cos(az), np.sin(az), np.zeros(count)], -1)
        bq = np.concatenate([np.cos(ang / 2)[:, None],
                             axis * np.sin(ang / 2)[:, None]], -1)
        drop = (_PUCK_HL * np.cos(ang) + _PUCK_R * np.sin(ang))
        z = 0.16 + drop - u(0.0, 0.002, (count,))
        st.update(body_pos=np.concatenate([rest_xy, z[:, None]], -1)
                  .astype(np.float32)[:, None],
                  body_quat=bq.astype(np.float32)[:, None],
                  body_angvel=u(-0.5, 0.5, (count, 1, 3)))
    elif kind in ('strike', 'cap'):
        q0 = _Q_LOW if kind == 'strike' else _q_cap()
        st.update(q=q0 + u(-0.01, 0.01, (count, 7)),
                  qd=u(-0.3, 0.3, (count, 7)), fq=u(0.0, 0.035, (count, 2)),
                  fqd=u(-0.05, 0.05, (count, 2)))
        if kind == 'strike':
            # across a side face of the pad, up to 3 mm in, or 1 mm clear
            side = rng.integers(0, 2, count)
            sgn = np.where(rng.random(count) < 0.5, -1.0, 1.0)
            fh = np.asarray(KM.FINGER_HALF_EXTENTS, np.float32)
            depth = fh[side] + _PUCK_R - u(-0.001, 0.003, (count,))
            along = u(-1.0, 1.0, (count,)) * fh[1 - side]
            local = np.zeros((count, 3), np.float32)
            local[np.arange(count), side] = sgn * depth
            local[np.arange(count), 1 - side] = along
            pos = _beside_pad(st, rng, count, local)
            pos[..., 2] = _PUCK_Z            # resting on the table
            # sliding toward the pad at up to 0.3 m/s
            ch = EP.fk_chain(t(st['q']), t(st['fq']))
            to_pad = n(ch['fpos']).mean(1) - pos[:, 0]
            to_pad[:, 2] = 0.0
            to_pad /= np.linalg.norm(to_pad, axis=-1, keepdims=True)
            st.update(body_pos=pos, body_linvel=(to_pad * u(
                0.0, 0.3, (count, 1))).astype(np.float32)[:, None])
        else:
            local = np.stack([u(-0.01, 0.01, (count,)),
                              u(-0.004, 0.004, (count,)),
                              0.04 + _PUCK_HL - u(0.0, 0.002, (count,))], -1)
            st.update(body_pos=_beside_pad(st, rng, count, local))
        ctl = mk_controls(count, st, seed)
    elif kind == 'coast':
        az = u(0.0, 2 * np.pi, (count,))
        v = 1.5 * np.stack([np.cos(az), np.sin(az), np.zeros(count)], -1)
        st.update(body_pos=np.concatenate(
            [rest_xy, np.full((count, 1), _PUCK_Z, np.float32)], -1)[:, None],
            body_linvel=v.astype(np.float32)[:, None],
            body_angvel=np.stack([np.zeros(count), np.zeros(count),
                                  u(-3.0, 3.0, (count,))], -1)
            .astype(np.float32)[:, None])
    elif kind == 'sphere':
        # a sphere of links 3-5 up to 3 mm into the puck's cap plane, the
        # puck centred under the lowest one
        cap = _PUCK_Z + _PUCK_HL
        q = _sphere_plane_configs(seed, cap)
        q = q[np.arange(count) % len(q)]
        ch = EP.fk_chain(t(q), torch.zeros((count, 2)))
        sph = n(ch['spheres'])
        low = np.asarray(KM.ARM_SPHERE_LINK) < 6
        reach = (cap + np.asarray(KM.ARM_SPHERE_RADIUS, np.float32)
                 - sph[..., 2])
        reach[:, ~low] = -np.inf
        k = reach.argmax(1)
        xy = sph[np.arange(count), k, :2]
        st.update(q=q, qd=u(-0.02, 0.02, (count, 7)),
                  body_pos=np.concatenate(
                      [xy, np.full((count, 1), _PUCK_Z, np.float32)], -1)
                  .astype(np.float32)[:, None])
        ctl.update(q_target=st['q'] + u(-0.01, 0.01, (count, 7)),
                   f_target=st['fq'].copy())
    else:
        raise ValueError(kind)
    return st, ctl


def k2_lane_groups(sc, lanes):
    """The lane group of each lane of a K2 plan (`lane_group`), the
    cylinder's body lanes named apart: its rim points on the table
    ('cyl-plane') and per pad a lateral and a vertical lane."""
    names = [lane_group(l) for l in lanes]
    if sc.has_body and sc.geom_type == S.CYLINDER:
        names[:8] = (['cyl-plane'] * 4
                     + ['finger-cyl lateral', 'finger-cyl vertical'] * 2)
    return names


# block positions of the multi-body 'drop' state (the JAX package's own
# tests/test_pallas_multibody.py)
_DROP_BLOCKS = np.array([[-0.50, 0.05, 0.21], [-0.45, -0.05, 0.19],
                         [-0.55, 0.0, 0.23], [-0.48, 0.10, 0.20],
                         [-0.52, -0.10, 0.22]], np.float32)
# the multi-body 'contact' pile, offsets from the bottom block of a stack
# of two: the top one (block 0, between the finger pads), the bottom one,
# one beside it along x with one on that, one on its other side
_PILE = np.array([[0.0, 0.0, 0.03], [0.0, 0.0, 0.0], [0.031, 0.0, 0.0],
                  [0.031, 0.0, 0.03], [-0.031, 0.0, 0.0]], np.float32)
# IK solution for the tip at (-0.52, 0, 0.205): the finger pads around the
# top block of the stack, the palm above it
_Q_STACK = np.array([0.0, -0.6311, 0.0, 1.7621, 0.0, -0.7484, 0.0],
                    np.float32)


def _tilted(rng, shape, tilt):
    q = np.concatenate([np.ones(shape + (1,), np.float32),
                        rng.uniform(-tilt, tilt, shape + (3,))
                        .astype(np.float32)], -1)
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def multi_inputs(nb, kind, count, seed=0):
    """Physics state and controls (numpy) for a scene of ``nb`` blocks:
    'drop' (the JAX package's multi-body test state: blocks dropped apart,
    arm at rest, fingers closing), 'contact' (a pile of blocks resting on
    each other, the fingers squeezing the top block of a stack while the
    arm holds: finger-box, box-box and box-plane lanes act)
    or 'sphere' (a wrist or elbow sphere on the table: sphere_inputs)."""
    rng = np.random.default_rng(seed)

    def u(lo, hi, shape):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    z3 = np.zeros((count, nb, 3), np.float32)
    st = mk_state(False, count, seed)
    st.update(body_pos=_DROP_BLOCKS[None, :nb] + u(-0.02, 0.02, (count, nb, 3)),
              body_quat=np.tile(np.array([1.0, 0, 0, 0], np.float32),
                                (count, nb, 1)),
              body_linvel=z3, body_angvel=z3)
    if kind == 'drop':
        return st, mk_controls(count)
    if kind == 'sphere':
        return sphere_inputs(st, count, seed)
    base = np.array([-0.52, 0.0, 0.176], np.float32)
    # resting contact: each block within 1 mm of the ones it sits on or
    # beside, slightly tilted; the finger pads within 1 mm of the top
    # block's sides (fq 0.02 touches it)
    gap = np.concatenate([u(-0.001, 0.001, (count, nb, 2)),
                          u(0.0, 0.001, (count, nb, 1))], -1)
    st.update(q=_Q_STACK + u(-0.02, 0.02, (count, 7)),
              qd=u(-0.02, 0.02, (count, 7)), fq=u(0.019, 0.021, (count, 2)),
              fqd=u(-0.02, 0.02, (count, 2)),
              body_pos=base + _PILE[None, :nb] * 1.01 + gap,
              body_quat=_tilted(rng, (count, nb), 0.02),
              body_linvel=u(-0.01, 0.01, (count, nb, 3)))
    # the arm holds within 0.01 rad of where it is; the fingers squeeze
    ctl = mk_controls(count)
    ctl['q_target'] = st['q'] + u(-0.01, 0.01, (count, 7))
    return st, ctl


# the Robotiq-85's stress states (robotiq_inputs): K2's, and K3's with the
# squeezed pile
ROBOTIQ_KINDS = ('grasp', 'stops', 'pad_table', 'sphere')
# blocks beyond the ones a Robotiq state places rest on the table apart
_ROBOTIQ_APART = np.array([[-0.45, -0.12, 0.175], [-0.60, 0.12, 0.175],
                           [-0.45, 0.12, 0.175], [-0.60, -0.12, 0.175],
                           [-0.40, 0.0, 0.175]], np.float32)


def _robotiq_q(tips):
    """IK solutions (numpy, (count, 7)) with the Robotiq-85's tip at
    ``tips`` (count, 3), from the canonical pose."""
    from pybullet_multigoal_gym_tpu_torch.ops import ik
    q0 = torch.as_tensor(np.asarray(KM.KUKA_REST_POSE, np.float32))
    return n(ik.solve(t(tips), q_init=q0.expand(len(tips), 7),
                      gripper='robotiq85'))


def robotiq_inputs(kind, count, seed=0, nb=1):
    """Physics state and controls (numpy) for a scene of ``nb`` blocks with
    the Robotiq-85 (finger joints are closure angles in [0, 0.804]):
    'grasp' (the JAX package's `test_robotiq_grasps_and_lifts_block`: the
    tip 35 mm above a block on the table, jittered by up to 3 mm, the pads
    open at 0.40-0.48 rad, 4-8 mm off the block's sides, and driven to
    0.804, so that they close on it within a control step), 'stops'
    (the arm at rest in the air; finger 0 driven into its open stop and
    finger 1 into its closed one, half the envs with targets beyond the
    range, half at the stops themselves), 'pad_table' (the tip low over
    the table, the short pads' bottoms up to 4 mm into it, the arm pressing
    down), 'sphere' (a wrist or elbow sphere on the table:
    sphere_inputs, joint control) and, with ``nb`` >= 2, 'pile' (a stack
    of two blocks, the pads around the top one and squeezing it). Blocks
    beyond those a state places rest on the table apart."""
    rng = np.random.default_rng(seed)

    def u(lo, hi, shape):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    z3 = np.zeros((count, nb, 3), np.float32)
    st = mk_state(False, count, seed)
    st.update(body_pos=np.tile(_ROBOTIQ_APART[:nb], (count, 1, 1)),
              body_quat=np.tile(np.array([1.0, 0, 0, 0], np.float32),
                                (count, nb, 1)),
              body_linvel=z3, body_angvel=z3.copy())
    if kind == 'sphere':
        return sphere_inputs(st, count, seed)
    ctl = mk_controls(count)
    block = np.array([-0.52, 0.0, 0.175], np.float32)
    if kind == 'grasp':
        st['body_pos'][:, 0] = block + np.concatenate(
            [u(-0.003, 0.003, (count, 2)), np.zeros((count, 1), np.float32)],
            -1)
        st.update(q=_robotiq_q(block + [0.0, 0.0, 0.035]
                               + u(-0.001, 0.001, (count, 3))),
                  fq=u(0.40, 0.48, (count, 2)))
        ctl['f_target'] = np.full((count, 2), KM.ROBOTIQ_JOINT_LIMIT,
                                  np.float32)
    elif kind == 'stops':
        st.update(q=np.tile(_robotiq_q(np.array([[-0.52, 0.0, 0.30]])),
                            (count, 1)),
                  fq=np.stack([u(0.0, 0.01, count), u(0.79, 0.804, count)],
                              -1),
                  fqd=np.stack([u(-1.5, -0.5, count), u(0.5, 1.5, count)],
                               -1))
        beyond = (np.arange(count) % 2 == 0)[:, None]
        ctl['f_target'] = np.where(
            beyond, np.array([-0.2, 1.0], np.float32),
            np.array([0.0, KM.ROBOTIQ_JOINT_LIMIT], np.float32))
    elif kind == 'pad_table':
        tips = (np.array([-0.52, 0.0, 0.1975], np.float32)
                + np.concatenate([u(-0.02, 0.02, (count, 2)),
                                  u(-0.001, 0.001, (count, 1))], -1))
        st.update(q=_robotiq_q(tips), fq=u(0.0, 0.1, (count, 2)),
                  qd=u(-0.02, 0.02, (count, 7)))
        ctl['q_target'] = _robotiq_q(tips - [0.0, 0.0, 0.01])
        ctl['f_target'] = st['fq'].copy()
    elif kind == 'pile' and nb >= 2:
        gap = np.concatenate([u(-0.001, 0.001, (count, 2, 2)),
                              u(0.0, 0.001, (count, 2, 1))], -1)
        st['body_pos'][:, :2] = (block + np.array([[0.0, 0.0, 0.0303],
                                                   [0.0, 0.0, 0.0]],
                                                  np.float32) + gap)
        st['body_quat'][:, :2] = _tilted(rng, (count, 2), 0.02)
        st.update(q=_robotiq_q(block + [0.0, 0.0, 0.0653]
                               + u(-0.001, 0.001, (count, 3))),
                  fq=u(0.48, 0.5, (count, 2)), fqd=u(-0.02, 0.02, (count, 2)))
        ctl['f_target'] = np.full((count, 2), KM.ROBOTIQ_JOINT_LIMIT,
                                  np.float32)
    else:
        raise ValueError('no Robotiq state %r with %d blocks' % (kind, nb))
    if kind != 'pad_table':
        ctl['q_target'] = st['q'].copy()
    return st, ctl


def lane_group(lane):
    """The contact-lane group of a K2 plain-version lane, from its
    metadata."""
    if lane.finger_idx >= 0:
        return 'finger-box' if lane.body_sgn else 'finger-plane'
    if lane.link >= 0:
        return 'sphere-box' if lane.body_sgn else 'sphere-plane'
    return 'box-plane'


def plain_run(sc, st, ctl, n_sub, noise_seed=None):
    """The plain control step (ops/engine_plain.py for a K2 scene,
    ops/multibody_plain.py for a K3 scene, substep by substep, as their
    `control_step` runs it). Returns the state after it and, per lane
    group, the share of envs where a lane of the group is active in some
    substep (K3's box-box lanes also per geom pair, 'box-box g-g2', and
    the edge lanes of the box-pinned group, 'box-pinned edge'). With
    ``noise_seed``, every element of the state moves by -1, 0 or +1 ulp
    (seeded) before each substep instead, and no shares are kept: the
    spread of such runs is the plain version's own sensitivity to rounding,
    which enters a run at every substep. On the card each substep replays
    a CUDA graph of the eager one (`_graphed`)."""
    track = noise_seed is None
    carry, ee, acc = _substeps(sc, _carry_of(sc, st), st.ee_contact_force,
                               ctl, n_sub, noise_seed, track)
    out = _state_of(sc, st, carry, ee)
    active = {}
    if acc is not None:
        for k, grp in _lane_names(sc, st):
            active[grp] = active.get(grp, False) | acc[:, k]
    return out, {k: float(v.float().mean()) for k, v in sorted(active.items())}


def plain_trajectory(sc, st, ctl, n_sub):
    """The plain version's states from ``st`` over ``n_sub`` substeps
    (`plain_run`'s arithmetic): the state before each substep, and after
    the last."""
    states = []

    def keep(carry, ee):
        states.append(_state_of(sc, st, [x.clone() for x in carry],
                                ee.clone()))

    carry, ee, _ = _substeps(sc, _carry_of(sc, st), st.ee_contact_force, ctl,
                             n_sub, visit=keep)
    keep(carry, ee)
    return states


def _carry_of(sc, st):
    if isinstance(sc, D.MultiBodyConsts):
        return MP.carry_of(sc, st)
    return (st.q, st.qd, st.fq, st.fqd, st.body_pos[:, 0], st.body_quat[:, 0],
            st.body_linvel[:, 0], st.body_angvel[:, 0])


def _state_of(sc, st, carry, ee):
    if isinstance(sc, D.MultiBodyConsts):
        return MP.state_of(st, carry, ee)
    q, qd, fq, fqd, bp, bq, bv, bw = carry
    return st._replace(q=q, qd=qd, fq=fq, fqd=fqd, body_pos=bp[:, None],
                       body_quat=bq[:, None], body_linvel=bv[:, None],
                       body_angvel=bw[:, None], ee_contact_force=ee)


def _lane_names(sc, st):
    """(lane index, group name) of each lane of ``sc``'s plan; K3's box-box
    lanes also under their geom pair and the box-pinned edge lanes under
    their own name."""
    if not isinstance(sc, D.MultiBodyConsts):
        bq = st.body_quat[:, 0]
        plan = EP.build_lanes(sc, EP.fk_chain(st.q, st.fq, sc.gripper),
                              st.body_pos[:, 0], bq,
                              EP.qmat(bq) if sc.has_body else None)
        return list(enumerate(k2_lane_groups(sc, plan)))
    names = list(enumerate(MP.lane_group(l) for l in MP.lane_plan(sc)))
    # per geom pair of two free bodies its 10 lanes, and the edge lane of
    # each free geom against each pinned geom
    pos = MP._plan_positions(sc)
    names += [(pos['pair', p] + j, 'box-box %d-%d' % p)
              for p in sc.geom_pairs for j in range(10)]
    names += [(at + 5, 'box-pinned edge') for key, at in pos.items()
              if key[0] == 'pinned']
    return names


def _substep_fn(sc, ctl, track):
    """One plain substep as a function of the carry's tensors: the next
    carry, the EE force and, with ``track``, whether each lane acts (N,
    lanes) at the carry it starts from."""
    multi = isinstance(sc, D.MultiBodyConsts)

    def fn(*carry):
        acts = ()
        if track:
            q, _, fq, _, bp, bq = carry[:6]
            if multi:
                act = MP.build_lanes(sc, EP.fk_chain(q, fq, sc.gripper), bp,
                                     bq, EP.qmat(bq), *carry[8:9])[3]
            else:
                plan = EP.build_lanes(sc, EP.fk_chain(q, fq, sc.gripper), bp,
                                      bq, EP.qmat(bq) if sc.has_body
                                      else None)
                act = torch.stack([l.active for l in plan], 1)
            acts = (act > 0,)
        if multi:
            nxt, ee = MP.substep(sc, carry, ctl.q_target, ctl.f_target,
                                 ctl.door_motor_on, ctl.door_target)
        else:
            nxt, ee = EP.substep(sc, carry, ctl.q_target, ctl.f_target)
        return tuple(nxt) + (ee,) + acts

    return fn


def _graphed(fn, args):
    """``fn`` captured once as a CUDA graph on copies of ``args``. Returns
    a function that copies its arguments in, replays the graph and returns
    ``fn``'s outputs (the graph's own tensors, which the next call
    overwrites). A replay launches the kernels an eager call of ``fn``
    launches, so its answers are the eager ones bit for bit; it spares the
    host the launch of each of a plain substep's thousands of small
    operations, which is what bounds an eager plain run on the card."""
    static = tuple(a.clone() for a in args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*static)         # fills the plain versions' per-device constants
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = fn(*static)

    def run(*new):
        for s, x in zip(static, new):
            s.copy_(x)
        graph.replay()
        return outs

    run.graph = graph
    return run


def _substeps(sc, carry, ee, ctl, n_sub, noise_seed=None, track=False,
              visit=None):
    """``n_sub`` plain substeps from ``carry``: with ``noise_seed`` each
    element moves by -1, 0 or +1 ulp before each; ``visit(carry, ee)``
    sees the carry before each. Returns the last carry and EE force, and
    with ``track`` whether each lane acted in some substep (N, lanes)."""
    fn = _substep_fn(sc, ctl, track)
    if carry[0].is_cuda:
        fn = _graphed(fn, carry)
    g = None if noise_seed is None else torch.Generator(
        device=carry[0].device).manual_seed(noise_seed)
    nc, acc = len(carry), None
    for _ in range(n_sub):
        if g is not None:
            carry = tuple(torch.nextafter(x, x + torch.randint(
                -1, 2, x.shape, generator=g, device=x.device).to(x.dtype))
                for x in carry)
        if visit is not None:
            visit(carry, ee)
        outs = fn(*carry)
        carry, ee = outs[:nc], outs[nc]
        if track:
            acc = outs[nc + 1].clone() if acc is None else acc | outs[nc + 1]
    return tuple(x.clone() for x in carry), ee.clone(), acc


class NoisyEngine:
    """Stands in for an env's control-step wrapper: the plain version with
    every state element moved by -1, 0 or +1 ulp before each substep
    (`plain_run`), a fresh noise seed each call. An env stepped with it
    shows how far the plain path's own rounding moves a step."""

    def __init__(self, sc):
        self.sc, self.calls, self.launches = sc, 0, 0

    def control_step(self, state, controls, n_substeps=100):
        self.calls += 1
        return plain_run(self.sc, state, controls, n_substeps,
                         noise_seed=self.calls)[0]


def noise_bound(sc, st, ctl, n_sub, ref, errors, tol, runs=8, factor=2.0):
    """Per-env bounds from the plain version's own sensitivity to rounding:
    ``runs`` noisy plain runs (`plain_run`), each env's spread (the largest
    ``errors(run, ref)``, a (N,) tensor) and its bound, the larger of
    ``tol`` and ``factor`` times the spread. The runs go as one batch of
    ``runs`` copies of the N envs, each copy with its own noise (the same
    arithmetic per env as ``runs`` separate runs, in one pass). Also how
    far a noisy run itself lies beyond the bound that the other runs set:
    in a chaotic state (a squeezed pile after 100 substeps) a run can take
    a branch of a contact decision that none of the others takes, and
    another rounding of the same physics, the kernel's, may too.
    ``allowed`` is the most envs one run puts beyond the others' bound,
    ``cap`` the largest share of that bound such an env reaches (1 where
    no run leaves it). Returns (bound, spread, allowed, cap)."""
    count = st.q.shape[0]

    def tile(nt):
        return type(nt)(*(torch.cat([x] * runs) for x in nt))

    out = plain_run(sc, tile(st), tile(ctl), n_sub, noise_seed=0)[0]
    errs = torch.stack([torch.as_tensor(errors(
        type(out)(*(x[k * count:(k + 1) * count] for x in out)), ref))
        for k in range(runs)])
    return spread_bound(errs, tol, factor)


def spread_bound(errs, tol, factor=2.0):
    """`noise_bound`'s figures from the errors ``errs`` (runs, N) of noisy
    runs against the reference: per env the bound, the larger of ``tol``
    and ``factor`` times its spread, and the spread; ``allowed``, the most
    envs one run puts beyond the other runs' bound, and ``cap``, the
    largest share of that bound such an env reaches (1 where none)."""
    spread = errs.max(0).values
    allowed, cap = 0, 1.0
    for k in range(errs.shape[0]):
        others = torch.clamp(factor * torch.cat([errs[:k], errs[k + 1:]])
                             .max(0).values, min=tol)
        out = errs[k] > others
        if out.any():
            allowed = max(allowed, int(out.sum()))
            cap = max(cap, float((errs[k][out] / others[out]).max()))
    return torch.clamp(factor * spread, min=tol), spread, allowed, cap


# the push-primitive scenes: each object's (x, y) in the 'drop' state
_PRIM_XY = {('slot', 'cube'): np.array([[-0.60, 0.06], [-0.46, -0.07]],
                                        np.float32),
            ('rectangle',): np.array([[-0.55, 0.0]], np.float32)}
# the objects rest at z 0.035 on the plate (plane z 0.02)
_PRIM_Z = 0.035


@functools.lru_cache(maxsize=None)
def primitive_rest():
    """The push-primitive family's rest pose (IK to the tip start (-0.52,
    0, 0.25), as `KukaEnvBase` derives it), numpy (7,)."""
    from pybullet_multigoal_gym_tpu_torch.ops import ik
    return n(ik.solve(t([-0.52, 0.0, 0.25]), q_init=t(KM.KUKA_REST_POSE)))


def _yaw_tilt(rng, shape, yaw, tilt):
    """Unit quaternions (numpy wxyz): a yaw in [-yaw, yaw] and a tilt of up
    to ``tilt`` about a random horizontal axis."""
    a = rng.uniform(-yaw, yaw, shape).astype(np.float32) * 0.5
    qz = np.stack([np.cos(a), 0 * a, 0 * a, np.sin(a)], -1)
    qt = _tilted(rng, shape, tilt) * np.array([1, 1, 1, 0], np.float32)
    qt /= np.linalg.norm(qt, axis=-1, keepdims=True)
    w1, x1, y1, z1 = np.moveaxis(qt, -1, 0)
    w2, x2, y2, z2 = np.moveaxis(qz, -1, 0)
    q = np.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                  w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                  w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                  w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def primitive_inputs(keys, kind, count, seed=0):
    """Physics state and controls (numpy) for a push-primitive scene
    (``keys``: ('slot', 'cube') or ('rectangle',)), as a primitive drives
    it: the fingers at their limit (the pads together), the arm servoing.
    'drop': the objects a few mm above the plate, turned and slightly
    tilted, the arm at the family's rest pose. 'press' (slot and cube): the
    cube in the slot's mouth within 1 mm of its three inner faces, the
    finger pads against its back, the arm pushing it in (toward +x):
    finger-box and box-box lanes, those of the slot's side geoms among
    them, act."""
    from pybullet_multigoal_gym_tpu_torch.ops import ik
    rng = np.random.default_rng(seed)

    def u(lo, hi, shape):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    nb = len(keys)
    rest = primitive_rest()
    st = mk_state(False, count, seed)
    z3 = np.zeros((count, nb, 3), np.float32)
    st.update(q=np.tile(rest, (count, 1)),
              fq=np.full((count, 2), KM.FINGER_LIMIT, np.float32),
              body_linvel=z3, body_angvel=z3.copy())
    ctl = mk_controls(count)
    ctl.update(q_target=st['q'].copy(),
               f_target=np.full((count, 2), KM.FINGER_LIMIT, np.float32))
    if kind == 'drop':
        xy = _PRIM_XY[keys][None] + u(-0.02, 0.02, (count, nb, 2))
        st.update(body_pos=np.concatenate(
            [xy, _PRIM_Z + u(0.001, 0.005, (count, nb, 1))], -1),
            body_quat=_yaw_tilt(rng, (count, nb), np.pi, 0.02))
        return st, ctl
    assert keys == ('slot', 'cube'), keys
    slot = np.array([-0.55, 0.0, _PRIM_Z], np.float32) + np.concatenate(
        [u(-0.01, 0.01, (count, 2)), u(0.0, 0.0005, (count, 1))], -1)
    # the mouth is 0.03 wide between the prongs, the cube 0.03: it sits
    # 0.03 m behind the slot's origin, against the base bar
    cube = slot + np.concatenate([-0.03 - u(0.0, 0.001, (count, 1)),
                                  u(-0.0005, 0.0005, (count, 1)),
                                  u(0.0, 0.0005, (count, 1))], -1)
    st.update(body_pos=np.stack([slot, cube], 1),
              body_quat=_yaw_tilt(rng, (count, nb), 0.02, 0.005),
              body_linvel=np.concatenate(
                  [z3[:, :1], np.concatenate([u(0.0, 0.02, (count, 1, 1)),
                                              z3[:, 1:, :2]], -1)], 1))
    # the pads (0.025 deep, 0.0125 half) behind the cube's back face
    tip = cube + np.concatenate([-0.0275 + u(0.0, 0.001, (count, 1)),
                                 u(-0.002, 0.002, (count, 1)),
                                 np.full((count, 1), 0.05 - _PRIM_Z,
                                         np.float32)], -1)
    rest_t = t(rest).expand(count, 7)
    q = ik.solve(t(tip), q_init=rest_t, rest_pose=rest_t)
    push = ik.solve(t(tip + np.array([0.02, 0.0, 0.0], np.float32)),
                    q_init=q, rest_pose=rest_t, num_iters=16)
    st.update(q=n(q), qd=u(-0.05, 0.05, (count, 7)))
    ctl.update(q_target=n(push))
    return st, ctl


# the insertion scene: body 0 the rectangle (free), body 1 the slot
# (pinned); the slot's end bar sits at (-0.06, 0, 0) in its frame
_SLOT_END_BAR = np.array([-0.06, 0.0, 0.0], np.float32)


def _yaw(a):
    """Unit quaternions (numpy wxyz) of yaws ``a``."""
    a = np.asarray(a, np.float32) * 0.5
    return np.stack([np.cos(a), 0 * a, 0 * a, np.sin(a)], -1).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _sphere_on_slot_configs(seed):
    """Arm configurations drawn around the rest pose within the joint
    limits whose lowest wrist or elbow sphere (links 4-6) hangs over the
    workspace, each with the slot placed so that its end bar lies under
    that sphere, its top 0-2 mm into the sphere, and the rectangle where
    'slot_pressed' puts it; kept where no other lane acts, and no finger
    pad comes within 1 cm of the slot or the rectangle. Returns (q (M, 7),
    slot position (M, 3))."""
    import dataclasses
    rng = np.random.default_rng(seed)
    lo = np.asarray(KM.JOINT_LIMIT_LOWER, np.float32)
    hi = np.asarray(KM.JOINT_LIMIT_UPPER, np.float32)
    cand = np.clip(np.asarray(KM.KUKA_REST_POSE, np.float32)
                   + rng.uniform(-1.6, 1.6, (16384, 7)).astype(np.float32),
                   lo, hi)
    fq = torch.zeros((len(cand), 2))
    ch = EP.fk_chain(t(cand), fq)
    spheres = n(ch['spheres'])
    bottom = spheres[..., 2] - np.asarray(KM.ARM_SPHERE_RADIUS, np.float32)
    wrist = np.asarray(KM.ARM_SPHERE_LINK) >= 4
    low = np.nonzero(wrist)[0][bottom[:, wrist].argmin(1)]
    rows = np.arange(len(cand))
    c, b = spheres[rows, low], bottom[rows, low]
    keep = ((b > 0.06) & (b < 0.3) & (c[:, 0] > -0.75) & (c[:, 0] < -0.35)
            & (np.abs(c[:, 1]) < 0.25))
    cand, c, b = cand[keep], c[keep], b[keep]
    slot = np.stack([c[:, 0], c[:, 1], b + rng.uniform(0.0, 0.002, len(b))
                     .astype(np.float32) - 0.015], -1) - _SLOT_END_BAR
    rect = slot + np.array([0.05, 0.0, 0.025], np.float32)
    bp = t(np.stack([rect, slot], 1))
    bq = t(np.stack([_yaw(np.full(len(b), 0.25)), _yaw(np.zeros(len(b)))],
                    1))
    sc = D.multibody_consts(S.insertion_scene())
    groups = np.array([MP.lane_group(l) for l in MP.lane_plan(sc)])
    ch = EP.fk_chain(t(cand), torch.zeros((len(cand), 2)))
    act = n(MP.build_lanes(sc, ch, bp, bq, EP.qmat(bq))[3]) > 0
    # the pads 1 cm clear: no finger lane acts on geoms 1 cm larger
    wide = dataclasses.replace(sc, geom_half=tuple(
        tuple(x + 0.01 for x in h) for h in sc.geom_half))
    near = n(MP.build_lanes(wide, ch, bp, bq, EP.qmat(bq))[3]) > 0
    fingers = np.isin(groups, ('finger-box', 'finger-pinned'))
    ok = (act[:, groups == 'sphere-pinned'].any(1)
          & ~act[:, groups != 'sphere-pinned'].any(1)
          & ~near[:, fingers].any(1))
    assert ok.sum() >= 16, ok.sum()
    return cand[ok], slot[ok]


def insertion_inputs(kind, count, seed=0):
    """Physics state and controls (numpy) for the insertion scene (body 0
    the rectangle, body 1 the pinned slot):
    'drop': the objects where a reset puts them, jittered (the slot resting
    on the plate, the rectangle up to 4 mm above it, each turned, the
    rectangle slightly tilted), the arm at the family's rest pose, the
    fingers closed.
    'load' (the JAX package's own state, tests/test_pallas_multibody.py:
    118-167): the rectangle on the slot's mouth between the finger pads,
    the pads resting on the slot's prongs and squeezing (box-pinned,
    finger-box and finger-pinned lanes act). Env 0 is that state itself;
    every other env's scene is turned about the arm's base axis by its own
    angle (the arm's first joint and the bodies together), which moves
    every bit and not the physics. The state is a nest of ties (the pads'
    faces on the rectangle's, its bottom edges on the pocket's, the pads'
    bottoms on the prongs' tops), so rounding alone decides contact
    branches in it from the first substep. (Jitter that presses a pad
    into a prong is worse: the pad's vertical lanes are then nearly
    degenerate, the finger moving only sideways, and their impulses run to
    thousands of N s, in the reference's engine too.)
    'slot_pressed' (:170-200): the rectangle, yawed 0.25 rad, moving into
    the slot's base bar at 0.25 m/s (box-pinned lanes, its edge lane among
    them, act), and an arm configuration whose wrist or elbow sphere rests
    on the slot's end bar while the arm holds (sphere-pinned lanes act;
    `_sphere_on_slot_configs`)."""
    rng = np.random.default_rng(seed)

    def u(lo, hi, shape):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    st = mk_state(False, count, seed)
    z3 = np.zeros((count, 2, 3), np.float32)
    st.update(body_linvel=z3, body_angvel=z3.copy())
    ctl = mk_controls(count)
    if kind == 'drop':
        rest = primitive_rest()
        xy = (np.array([[-0.46, -0.07], [-0.60, 0.06]], np.float32)[None]
              + u(-0.02, 0.02, (count, 2, 2)))
        z = np.stack([0.06 + u(0.0, 0.004, (count,)),
                      np.full(count, 0.03, np.float32)], -1)[..., None]
        quat = _yaw_tilt(rng, (count, 2), np.pi, 0.02)
        quat[:, 1] = _yaw(u(-np.pi, np.pi, (count,)))
        st.update(q=np.tile(rest, (count, 1)),
                  fq=np.full((count, 2), KM.FINGER_LIMIT, np.float32),
                  body_pos=np.concatenate([xy, z], -1), body_quat=quat)
        ctl.update(q_target=st['q'].copy(),
                   f_target=np.full((count, 2), KM.FINGER_LIMIT, np.float32))
        return st, ctl
    if kind == 'load':
        fq0 = np.full((1, 2), 0.02, np.float32)
        q = np.asarray(KM.KUKA_REST_POSE, np.float32)[None]
        mid = n(EP.fk_chain(t(q), t(fq0))['fpos'])[0].mean(0)
        bodies = np.stack([mid, mid + np.array([0.03, 0.0, -0.055])])
        turn = u(-0.3, 0.3, (count,))
        turn[0] = 0.0           # env 0: the JAX package's state itself
        c, s_ = np.cos(turn)[:, None], np.sin(turn)[:, None]
        x, y = bodies[None, :, 0], bodies[None, :, 1]
        q = np.tile(q, (count, 1))
        q[:, 0] += turn
        st.update(q=q, fq=np.tile(fq0, (count, 1)),
                  body_pos=np.stack([c * x - s_ * y, s_ * x + c * y,
                                     np.broadcast_to(bodies[None, :, 2],
                                                     (count, 2))], -1)
                  .astype(np.float32),
                  body_quat=np.repeat(_yaw(turn)[:, None], 2, 1))
        ctl.update(q_target=q.copy())
        return st, ctl
    assert kind == 'slot_pressed', kind
    q, slot = _sphere_on_slot_configs(seed)
    pick = rng.integers(0, len(q), count)
    slot = slot[pick]
    rect = slot + np.array([0.05, 0.0, 0.025], np.float32) + u(
        -0.001, 0.001, (count, 3))
    vel = np.zeros((count, 2, 3), np.float32)
    vel[:, 0, 0] = -0.25 + u(-0.05, 0.05, (count,))
    st.update(q=q[pick], qd=u(-0.02, 0.02, (count, 7)),
              body_pos=np.stack([rect, slot], 1),
              body_quat=np.stack([_yaw(0.25 + u(-0.05, 0.05, (count,))),
                                  _yaw(np.zeros(count))], 1),
              body_linvel=vel)
    ctl.update(q_target=q[pick] + u(-0.01, 0.01, (count, 7)),
               f_target=np.zeros((count, 2), np.float32))
    return st, ctl


# the chest scenes (tests/test_torch_chest.py, chip_smoke.py): the door kind
# of each chest task, and the tip's start (the family's rest pose)
CHEST_DOOR = {'chest_push': 'front_sliding',
              'chest_pick_and_place': 'up_sliding'}
_CHEST_TIP = {'front_sliding': (-0.52, 0.0, 0.176),
              'up_sliding': (-0.52, 0.0, 0.25)}
# blocks on the table beside the chest, apart (x, y)
_CHEST_TABLE = np.array([[-0.50, 0.08], [-0.45, -0.06], [-0.42, 0.10],
                         [-0.48, -0.13], [-0.40, -0.01]], np.float32)


@functools.lru_cache(maxsize=None)
def chest_rest(door):
    """The chest family's rest pose for ``door`` (IK to its tip start, as
    `KukaEnvBase` derives it), numpy (7,)."""
    from pybullet_multigoal_gym_tpu_torch.ops import ik
    return n(ik.solve(t(_CHEST_TIP[door]), q_init=t(KM.KUKA_REST_POSE)))


def _tip_q(door, tips):
    """IK (40 iterations from the rest pose) for tip targets (count, 3),
    numpy."""
    from pybullet_multigoal_gym_tpu_torch.ops import ik
    rest = t(chest_rest(door)).expand(len(tips), 7)
    return n(ik.solve(t(tips), q_init=rest, rest_pose=rest))


def chest_inputs(door, nb, kind, count, seed=0):
    """Physics state and controls (numpy) for the chest scene of ``door``
    ('front_sliding': chest_push's, 'up_sliding': chest_pick_and_place's)
    with ``nb`` blocks. The chest's walls span x [-0.695, -0.605], y
    [-0.07, 0.07] up to z 0.26 (the back wall at x -0.7, the up_sliding
    chest's front wall at -0.6); the front_sliding door is the front face
    at x -0.597, its handle at x -0.567, z 0.25, sliding +y; the up_sliding
    door is the lid at z 0.267, its handle at (-0.58, 0.065, 0.292),
    sliding -x.
    'drop': the door open, block 0 dropped inside the chest against its
    left wall (box-static lanes act), the others dropped on the table
    beside it, the arm at the family's rest pose.
    'handle': the door nearly closed, the pads against its handle and the
    arm driving them along the door's axis (the expert's sweep,
    tests/policies.py:319-330 and :378-389) with the motor off:
    finger-door lanes act and the door moves.
    'door_block': the door closed; in even envs a block pressed by the
    pads against the door (front_sliding: its face, as in the JAX package's
    `test_block_trapped_against_door_stalls`; up_sliding: a block on the lid
    pushed along it), in odd envs a block pressed against the door and the
    pads on the handle at once (box-door and finger-door lanes in one env).
    'hold_open': the door's motor on, the door within 3 mm of its limit
    and moving into the stop; the arm leans on the chest's left wall, a pad
    on its outer face and the palm sphere on its top edge (finger-static
    and sphere-static lanes act).
    'spawn': the reset pose, blocks resting on the table, the door closed,
    zero actions (for chest_push the palm sphere grazes the door's handle,
    as in the JAX package's `test_chest_quiescence`)."""
    rng = np.random.default_rng(seed)

    def u(lo, hi, shape=()):
        return rng.uniform(lo, hi, (count,) + shape).astype(np.float32)

    limit = 0.12 if door == 'front_sliding' else 0.10
    front = door == 'front_sliding'
    rest = chest_rest(door)
    z3 = np.zeros((count, nb, 3), np.float32)
    st = mk_state(False, count, seed)
    table = np.concatenate(
        [_CHEST_TABLE[None, :nb] + u(-0.01, 0.01, (nb, 2)),
         np.full((count, nb, 1), 0.175, np.float32)], -1)
    st.update(q=np.tile(rest, (count, 1)),
              fq=np.full((count, 2), KM.FINGER_LIMIT, np.float32),
              body_pos=table, body_quat=np.tile(np.array(
                  [1.0, 0, 0, 0], np.float32), (count, nb, 1)),
              body_linvel=z3, body_angvel=z3.copy())
    ctl = mk_controls(count)
    ctl.update(q_target=st['q'].copy(),
               f_target=np.full((count, 2), KM.FINGER_LIMIT, np.float32))
    if kind == 'spawn':
        return st, ctl
    if kind == 'drop':
        bp = table.copy()
        bp[:, 1:, 2] += u(0.001, 0.02, (nb - 1,))
        # block 0 inside, within 1 mm of the left wall's inner face (y 0.06)
        bp[:, 0] = np.stack([-0.65 + u(-0.01, 0.01), 0.045 + u(-0.001, 0.0005),
                             0.176 + u(0.0, 0.01)], -1)
        st.update(body_pos=bp, body_quat=_tilted(rng, (count, nb), 0.01),
                  door_q=np.full(count, limit, np.float32))
        return st, ctl
    if kind == 'hold_open':
        # the pad 0.5 mm into the wall's outer face (y 0.07), the palm
        # sphere (0.065 above the tip, radius 0.028) 0-1 mm into its top edge
        tips = np.stack([-0.63 + u(-0.01, 0.01), 0.0795 + u(-0.0003, 0.0003),
                         0.2208 + u(-0.0007, 0.0)], -1)
        q = _tip_q(door, tips)
        st.update(q=q, qd=u(-0.01, 0.01, (7,)),
                  door_q=limit - u(0.0, 0.003), door_qd=u(0.02, 0.1))
        ctl.update(q_target=q + u(-0.005, 0.005, (7,)),
                   door_motor_on=np.ones(count, bool),
                   door_target=np.full(count, limit, np.float32))
        return st, ctl
    odd = np.arange(count) % 2 == 1
    if kind == 'handle':
        dq = u(0.0, 0.03)
        if front:     # the pads on the handle's -y face, sweeping +y
            tips = np.stack([-0.567 + u(-0.003, 0.003),
                             dq - 0.0195 + u(-0.0003, 0.0003),
                             0.215 + u(-0.005, 0.005)], -1)
            step = np.array([0.0, 0.01, 0.0], np.float32)
        else:         # the pads on the handle's +x face, sweeping -x
            tips = np.stack([-0.5475 - dq + u(-0.0003, 0.0003),
                             0.065 + u(-0.003, 0.003),
                             0.26 + u(-0.005, 0.005)], -1)
            step = np.array([-0.01, 0.0, 0.0], np.float32)
        st.update(door_q=dq)
    else:
        assert kind == 'door_block', kind
        bp = st['body_pos']
        if front:
            # even: the block against the face at |y| in [0.035, 0.055],
            # the pads behind it; odd: the block under the handle, the pads
            # on the handle's -y face
            y = np.where(odd, u(-0.005, 0.005), np.where(
                rng.random(count) < 0.5, 1, -1) * u(0.035, 0.055))
            bp[:, 0] = np.stack([-0.577 + u(0.0, 0.0005), y,
                                 np.full(count, 0.175, np.float32)], -1)
            tips = np.where(odd[:, None], np.stack(
                [-0.567 + u(-0.003, 0.003), -0.0195 + u(-0.0003, 0.0003),
                 np.full(count, 0.215, np.float32)], -1), np.stack(
                [bp[:, 0, 0] + 0.0275 - u(0.0, 0.0005), y,
                 np.full(count, 0.185, np.float32)], -1))
            step = np.where(odd[:, None], np.array([0.0, 0.01, 0.0]),
                            np.array([-0.01, 0.0, 0.0])).astype(np.float32)
        else:
            # the block on the lid (top z 0.272); even: the pads behind its
            # +x face pushing -x, odd: the pads on the handle's +x face
            bp[:, 0] = np.stack([-0.65 + u(-0.02, 0.02), u(-0.02, 0.02),
                                 0.287 + u(-0.0005, 0.0)], -1)
            tips = np.where(odd[:, None], np.stack(
                [-0.5475 + u(-0.0003, 0.0003), 0.065 + u(-0.003, 0.003),
                 np.full(count, 0.26, np.float32)], -1), np.stack(
                [bp[:, 0, 0] + 0.0275 - u(0.0, 0.0005), bp[:, 0, 1],
                 np.full(count, 0.2895, np.float32)], -1))
            step = np.array([-0.01, 0.0, 0.0], np.float32)
        vel = z3.copy()
        vel[:, 0, 0] = -u(0.0, 0.05)
        st.update(body_pos=bp, body_linvel=vel)
    q = _tip_q(door, tips.astype(np.float32))
    push = _tip_q(door, (tips + step).astype(np.float32))
    st.update(q=q, qd=((push - q) * 5.0).astype(np.float32))
    ctl.update(q_target=push)
    return st, ctl


# the door-opening drive (tests/policies.py:ChestPushExpert, phases 0-3):
# above the handle's -y side, and down at the handle's height
_HANDLE_ABOVE = (-0.567, -0.06, 0.33)
_HANDLE_LOW = (-0.567, -0.06, 0.215)


def door_opening_action(obs, phase):
    """One step of phases 0-3 of the JAX package's chest_push expert
    (tests/policies.py:296-332) for a batch of envs at once: 0 rise until the
    tip is above 0.32, 1 go above the handle's -y side, 2 descend to the
    handle's height, 3 sweep +y until the door has slid to 0.112; then 4
    retreat up and back until above 0.3, 5 hold still. Each env's action
    comes from its phase, and then its phase moves on from the same
    observation, as the expert does it. Returns (actions (N, 3), phase)."""
    grip = obs['policy_state'][:, :3]
    door_q = obs['achieved_goal'][:, 0]
    above, low = t(_HANDLE_ABOVE, grip.device), t(_HANDLE_LOW, grip.device)
    acts = torch.stack([
        t([0.0, 0.0, 1.0], grip.device).expand_as(grip),
        torch.clamp((above - grip) * 25, -1, 1),
        torch.clamp((low - grip) * 25, -1, 1),
        t([0.0, 1.0, 0.0], grip.device).expand_as(grip),
        t([-0.3, -0.5, 1.0], grip.device).expand_as(grip),
        torch.zeros_like(grip)], 1)
    a = acts[torch.arange(len(phase), device=grip.device), phase]
    step = torch.stack([
        grip[:, 2] > 0.32,
        torch.linalg.vector_norm(grip[:, :2] - above[:2], dim=-1) < 0.008,
        (grip[:, 2] - low[2]).abs() < 0.005,
        door_q >= 0.112,
        grip[:, 2] > 0.3,
        torch.zeros_like(door_q, dtype=torch.bool)], 1)
    moves = step[torch.arange(len(phase), device=grip.device), phase]
    return a, phase + moves.long()
