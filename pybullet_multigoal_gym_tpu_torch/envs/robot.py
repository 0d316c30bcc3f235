"""Robot state extraction, batched: counterpart of
`pybullet_multigoal_gym_tpu/envs/robot.py` (`Kuka.calc_robot_state`),
computed from one FK pass and the analytic tip Jacobian."""

import torch

from pybullet_multigoal_gym_tpu_torch.maths import quat as quatm
from pybullet_multigoal_gym_tpu_torch.model import kuka_model as KM
from pybullet_multigoal_gym_tpu_torch.ops import fk
from pybullet_multigoal_gym_tpu_torch.utils.tensors import const

# the EE force sensor's clip (N), at its consumer in the reference
EE_FORCE_LIMIT = 50.0


def robot_state(q, qd, fq, fqd, grasping: bool, ee_contact_force=None,
                gripper: str = 'parallel_jaw'):
    """A dict of the robot-state fields of ``gripper``: tip pose (rpy in
    PyBullet's Euler convention), tip velocities from the Jacobian, finger
    closeness (the distance between the two finger tabs, for either
    gripper) and finger velocity ((base_vel - finger_tab_vel)[y], the
    Robotiq-85's tab moving along its closure angle's velocity, which is
    not a unit vector). With ``ee_contact_force`` (the engine's world-frame
    contact force on the gripper), also the EE force sensor
    ``ee_joint_force``: that force plus the gravity load of the distal
    subtree (link 7, the gripper base and the fingers: ``KM.EE_SUBTREE_MASS``,
    or ``KM.ROBOTIQ_EE_SUBTREE_MASS`` with the linkage), a constant world -z
    force, turned into link 7's frame, so that the reading depends on the
    orientation as Bullet's joint-frame sensor does, and clipped to +-50 N
    (JAX `envs/robot.py:59-72`)."""
    pos, rot = fk.link_frames(q)
    frames = fk.ee_frames(q, fq, gripper, frames=(pos, rot))
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

    out = {
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
    if ee_contact_force is not None:
        subtree = (KM.ROBOTIQ_EE_SUBTREE_MASS if gripper == 'robotiq85'
                   else KM.EE_SUBTREE_MASS)
        g_load = subtree * 9.81
        f_world = ee_contact_force + const([0.0, 0.0, -g_load], q)
        out['ee_joint_force'] = torch.clamp(quatm.rotate_inv(r7, f_world),
                                            -EE_FORCE_LIMIT, EE_FORCE_LIMIT)
    return out
