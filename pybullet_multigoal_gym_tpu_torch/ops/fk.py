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


def ee_frames(q, finger_q, frames=None):
    """All end-effector frames of the parallel-jaw gripper that the env
    layer needs, from one FK pass (``frames``: an optional
    ``link_frames(q)`` result to reuse).

    Returns a dict of world positions (and the tip rotation): tip, tip_rot,
    hand_cam, gripper_base, finger_pos (..., 2, 3) [pad box centres],
    finger_rot, finger_tab (..., 2, 3), finger_axis_l7 (..., 2, 3)
    [link-7-frame pad velocity per unit finger_qd].
    """
    pos, rot = link_frames(q) if frames is None else frames
    p7, r7 = pos[..., 6, :], rot[..., 6, :]
    tip = _tip(pos, rot, 'parallel_jaw')
    hand_cam = p7 + quatm.rotate(r7, const(KM.HAND_CAM_OFFSET, q))
    gbase = p7 + quatm.rotate(r7, const(KM.GRIPPER_BASE_OFFSET, q))
    faxis = const(KM.FINGER_AXIS, q)
    # finger local offset = origin + axis * joint position
    floc = const(KM.FINGER_ORIGIN, q) + faxis * finger_q[..., :, None]
    r7f = r7[..., None, :]
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
        'finger_axis_l7': faxis.expand(fpos.shape),
    }


def tip_jacobian(q, gripper: str = 'parallel_jaw'):
    """Analytic geometric Jacobian of the gripper tip: (..., 6, 7)."""
    pos, rot = link_frames(q)
    return _jacobian(pos, rot, _tip(pos, rot, gripper))
