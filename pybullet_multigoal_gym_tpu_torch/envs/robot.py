"""Robot state extraction, batched: counterpart of
`pybullet_multigoal_gym_tpu/envs/robot.py` (`Kuka.calc_robot_state`),
computed from one FK pass and the analytic tip Jacobian."""

import torch

from pybullet_multigoal_gym_tpu_torch.maths import quat as quatm
from pybullet_multigoal_gym_tpu_torch.ops import fk


def robot_state(q, qd, fq, fqd, grasping: bool):
    """A dict of the robot-state fields (parallel-jaw gripper): tip pose
    (rpy in PyBullet's Euler convention), tip velocities from the Jacobian,
    finger closeness (the distance between the two finger tabs) and finger
    velocity ((base_vel - finger_tab_vel)[y])."""
    pos, rot = fk.link_frames(q)
    frames = fk.ee_frames(q, fq, frames=(pos, rot))
    r7 = rot[..., 6, :]
    tip = frames['tip']
    jac = fk._jacobian(pos, rot, tip)                     # (..., 6, 7)
    v_tip = (jac[..., :3, :] * qd[..., None, :]).sum(-1)
    omega = (jac[..., 3:, :] * qd[..., None, :]).sum(-1)

    if grasping:
        tab = frames['finger_tab']                         # (..., 2, 3)
        closeness = torch.linalg.vector_norm(
            tab[..., 0, :] - tab[..., 1, :], dim=-1, keepdim=True)
        # world velocity of a point p rigidly attached: v_tip + omega x (p - tip)
        base_v = v_tip + quatm.cross(omega, frames['gripper_base'] - tip)
        axis_w = quatm.rotate(frames['finger_rot'], frames['finger_axis_l7'])
        tab1_v = (v_tip + quatm.cross(omega, tab[..., 0, :] - tip)
                  + axis_w[..., 0, :] * fqd[..., 0:1])
        finger_vel = (base_v - tab1_v)[..., 1:2]
    else:
        closeness = q.new_zeros(q.shape[:-1] + (1,))
        finger_vel = q.new_zeros(q.shape[:-1] + (1,))

    return {
        'gripper_xyz': tip,
        'gripper_rpy': quatm.quat_to_euler_xyz(r7),
        'gripper_finger_closeness': closeness,
        'gripper_vel_xyz': v_tip,
        'gripper_vel_rpy': omega,
        'gripper_finger_vel': finger_vel,
        'joint_poses': q,
        'tip_rot': r7,
        'frames': frames,
    }
