"""Batched forward kinematics for the Kuka iiwa14 chain (torch).

Counterpart of `pybullet_multigoal_gym_tpu/ops/fk.py`: a pure function of
the joint vector, unrolled over the 7 joints, batched over leading axes.
"""

import numpy as np
import torch

from pybullet_multigoal_gym_tpu_torch.maths import quat as quatm
from pybullet_multigoal_gym_tpu_torch.model import kuka_model as KM
from pybullet_multigoal_gym_tpu_torch.utils.tensors import const


def _np_euler_xyz_to_quat(rpy):
    r, p, y = rpy[..., 0] * 0.5, rpy[..., 1] * 0.5, rpy[..., 2] * 0.5
    cr, sr, cp, sp, cy, sy = (np.cos(r), np.sin(r), np.cos(p), np.sin(p),
                              np.cos(y), np.sin(y))
    return np.stack([
        cr * cp * cy + sr * sp * sy,
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
    ], axis=-1)


# Static per-joint origin rotations (wxyz), computed host-side in float64.
ORIGIN_QUAT_NP = _np_euler_xyz_to_quat(KM.JOINT_ORIGIN_RPY)


def link_frames(q):
    """World pose of the 7 joint frames.

    Args:
      q: (..., 7) arm joint angles.
    Returns:
      pos: (..., 7, 3) joint-frame origins, rot: (..., 7, 4) wxyz quaternions.
    """
    batch = q.shape[:-1]
    p = q.new_zeros(batch + (3,))
    r = const([1.0, 0.0, 0.0, 0.0], q).expand(batch + (4,))
    ps, rs = [], []
    for j in range(7):
        p = p + quatm.rotate(r, const(KM.JOINT_ORIGIN_XYZ[j], q))
        r = quatm.mul(r, const(ORIGIN_QUAT_NP[j], q).expand(batch + (4,)))
        # revolute joint about local z
        half = q[..., j] * 0.5
        zero = torch.zeros_like(half)
        r = quatm.mul(r, torch.stack([torch.cos(half), zero, zero,
                                      torch.sin(half)], dim=-1))
        ps.append(p)
        rs.append(r)
    return torch.stack(ps, dim=-2), torch.stack(rs, dim=-2)


def _tip(pos, rot, gripper):
    return pos[..., 6, :] + quatm.rotate(
        rot[..., 6, :], const(KM.tip_offset_for(gripper), pos))


def _jacobian(pos, rot, tip):
    """(..., 6, 7): rows 0-2 linear (z_i x (tip - p_i)), rows 3-5 angular."""
    z = quatm.rotate(rot, const([0.0, 0.0, 1.0], pos))
    jv = quatm.cross(z, tip[..., None, :] - pos)
    return torch.cat([jv, z], dim=-1).transpose(-1, -2)


def tip_pose(q, gripper: str = 'parallel_jaw'):
    """Gripper-tip world position and orientation (wxyz)."""
    pos, rot = link_frames(q)
    return _tip(pos, rot, gripper), rot[..., 6, :]


def robotiq_pads(fq):
    """The Robotiq-85's pads in link 7's frame (`KM.robotiq_pad_kinematics`)
    for closure angles ``fq`` (..., 2): the pad tabs (the closeness
    endpoints), the pad box centres and the pad velocity per unit closure
    rate, each (..., 2, 3). Summed in the order of the Pallas kernel's
    `fk_chain` (`pallas_engine.py:149-165`), which gives the XLA engine's
    values bit for bit: the base offset last, the pad's half thickness
    inside the side's sign. |vel| is ``KM.ROBOTIQ_ARM_LEN`` m/rad, not 1."""
    s = const([1.0, -1.0], fq)
    ct, st = torch.cos(fq), torch.sin(fq)
    pad_x = (KM.ROBOTIQ_INNER_X + KM.ROBOTIQ_ARM_TX * ct
             + KM.ROBOTIQ_ARM_TY * st + KM.ROBOTIQ_TAB_X
             + KM.ROBOTIQ_BASE_OFFSET[2])
    inner_y = (KM.ROBOTIQ_INNER_Y + KM.ROBOTIQ_ARM_TY * ct
               - KM.ROBOTIQ_ARM_TX * st - KM.ROBOTIQ_TAB_Y)
    dx = -KM.ROBOTIQ_ARM_TX * st + KM.ROBOTIQ_ARM_TY * ct
    dy = -s * (KM.ROBOTIQ_ARM_TX * ct + KM.ROBOTIQ_ARM_TY * st)
    zero = torch.zeros_like(ct)
    return {
        'tab': torch.stack([zero, s * inner_y, pad_x], -1),
        'center': torch.stack(
            [zero, s * (inner_y + KM.ROBOTIQ_PAD_HALF[1]), pad_x], -1),
        'vel': torch.stack([zero, dy, dx], -1),
    }


def ee_frames(q, finger_q, gripper: str = 'parallel_jaw', frames=None):
    """All end-effector frames that the env layer needs, from one FK pass
    (``frames``: an optional ``link_frames(q)`` result to reuse).
    ``finger_q`` is (..., 2): prismatic metres for the parallel jaw,
    closure radians for the Robotiq-85, whose pads hang from link 7's
    origin (`robotiq_pads`).

    Returns a dict of world positions (and the tip rotation): tip, tip_rot,
    hand_cam, gripper_base, finger_pos (..., 2, 3) [pad box centres],
    finger_rot, finger_tab (..., 2, 3), finger_axis_l7 (..., 2, 3)
    [link-7-frame pad velocity per unit finger_qd].
    """
    pos, rot = link_frames(q) if frames is None else frames
    p7, r7 = pos[..., 6, :], rot[..., 6, :]
    tip = _tip(pos, rot, gripper)
    hand_cam = p7 + quatm.rotate(r7, const(KM.hand_cam_offset_for(gripper), q))
    gbase = p7 + quatm.rotate(r7, const(KM.GRIPPER_BASE_OFFSET, q))
    r7f = r7[..., None, :]
    if gripper == 'robotiq85':
        pads = robotiq_pads(finger_q)
        fpos = p7[..., None, :] + quatm.rotate(r7f, pads['center'])
        ftab_pos = p7[..., None, :] + quatm.rotate(r7f, pads['tab'])
        faxis = pads['vel']
    else:
        faxis = const(KM.FINGER_AXIS, q).expand(finger_q.shape + (3,))
        # finger local offset = origin + axis * joint position
        floc = const(KM.FINGER_ORIGIN, q) + faxis * finger_q[..., :, None]
        fpos = gbase[..., None, :] + quatm.rotate(r7f, floc)
        ftab_pos = fpos + quatm.rotate(r7f, const(KM.FINGER_TAB_OFFSET, q))
    return {
        'tip': tip,
        'tip_rot': r7,
        'hand_cam': hand_cam,
        'gripper_base': gbase,
        'finger_pos': fpos,
        'finger_rot': r7f.expand(fpos.shape[:-1] + (4,)),
        'finger_tab': ftab_pos,
        'finger_axis_l7': faxis,
    }


def tip_jacobian(q, gripper: str = 'parallel_jaw'):
    """Analytic geometric Jacobian of the gripper tip: (..., 6, 7)."""
    pos, rot = link_frames(q)
    return _jacobian(pos, rot, _tip(pos, rot, gripper))
