"""Compiled Kuka iiwa14 model: static arrays describing the kinematic chain.

This is the replacement for runtime URDF parsing
(`pybullet_multigoal_gym/robots/robot_bases.py:62-84`): the
model is compiled offline into plain constants that live in the step program.
Numbers come from
`pybullet_multigoal_gym/assets/robots/kuka/iiwa14_parallel_jaw.urdf`
(joints at lines 94-455) and the Robotiq variant where noted.

Frames (all relative to the world; the robot base is fixed at the origin via
the `plane_iiwa_joint`, URDF line 61-65):

  world -> link0 -> [j1..j7 revolute about local z] -> link7
  link7 -> gripper_tip   (fixed, +0.12 z,  URDF:311-315)
  link7 -> hand_cam      (fixed, +0.20 x,  URDF:332-336)
  link7 -> gripper_base  (fixed, +0.055 z, URDF:394-398)
  gripper_base -> finger1 (prismatic, origin (0, 0.04, 0.04), axis (0,-1,0))
  gripper_base -> finger2 (prismatic, origin (0,-0.04, 0.04), axis (0, 1,0))
  finger_i -> finger_tab_i (fixed, -/+0.005 y)
"""

import numpy as np

PI = np.pi
HALF_PI = np.pi / 2.0

# Per-joint parent-frame origins: xyz and rpy (URDF extrinsic XYZ euler).
# iiwa14_parallel_jaw.urdf:94-285.
JOINT_ORIGIN_XYZ = np.array([
    [0.0, 0.0, 0.1575],      # iiwa_joint_1
    [0.0, 0.0, 0.2025],      # iiwa_joint_2
    [0.0, 0.2045, 0.0],      # iiwa_joint_3
    [0.0, 0.0, 0.2155],      # iiwa_joint_4
    [0.0, 0.1845, 0.0],      # iiwa_joint_5
    [0.0, 0.0, 0.2155],      # iiwa_joint_6
    [0.0, 0.081, 0.0],       # iiwa_joint_7
], dtype=np.float64)

JOINT_ORIGIN_RPY = np.array([
    [0.0, 0.0, 0.0],
    [HALF_PI, 0.0, PI],
    [HALF_PI, 0.0, PI],
    [HALF_PI, 0.0, 0.0],
    [-HALF_PI, PI, 0.0],
    [HALF_PI, 0.0, 0.0],
    [-HALF_PI, PI, 0.0],
], dtype=np.float64)

# All seven arm joints rotate about their local z axis (URDF `<axis xyz="0 0 1"/>`).
JOINT_LIMIT_LOWER = np.array(
    [-2.96705972839, -2.09439510239, -2.96705972839, -2.09439510239,
     -2.96705972839, -2.09439510239, -3.05432619099], dtype=np.float64)
JOINT_LIMIT_UPPER = -JOINT_LIMIT_LOWER
JOINT_EFFORT = 300.0          # URDF effort cap; PD drive uses 200 (kuka.py:288)
JOINT_MAX_VELOCITY = 10.0
JOINT_DAMPING = 0.5           # URDF <dynamics damping="0.5"/>

# Link masses, kg (iiwa14_parallel_jaw.urdf inertial blocks).
LINK_MASS = np.array([5.0, 4.0, 4.0, 3.0, 2.7, 1.7, 1.8, 0.3], dtype=np.float64)

# Fixed end-effector frames relative to link 7 (URDF:311-398). The tip and
# hand-cam frames are GRIPPER-SPECIFIC: the Robotiq body is longer, so its
# URDF puts the tip at +0.18 z (iiwa14_robotiq85.urdf:311-315) vs the
# parallel jaw's +0.12 (iiwa14_parallel_jaw.urdf:311-315) — IK targets,
# observations and EE bounds all follow the loaded gripper's tip.
TIP_OFFSET = np.array([0.0, 0.0, 0.12], dtype=np.float64)
HAND_CAM_OFFSET = np.array([0.2, 0.0, 0.0], dtype=np.float64)
GRIPPER_BASE_OFFSET = np.array([0.0, 0.0, 0.055], dtype=np.float64)
ROBOTIQ_TIP_OFFSET = np.array([0.0, 0.0, 0.18], dtype=np.float64)
ROBOTIQ_HAND_CAM_OFFSET = np.array([0.22, 0.0, -0.1], dtype=np.float64)


def tip_offset_for(gripper: str):
    return ROBOTIQ_TIP_OFFSET if gripper == 'robotiq85' else TIP_OFFSET


def hand_cam_offset_for(gripper: str):
    return ROBOTIQ_HAND_CAM_OFFSET if gripper == 'robotiq85' else HAND_CAM_OFFSET

# Parallel-jaw gripper (URDF:418-455): two prismatic fingers, range 0..0.035,
# axes (0,-1,0) and (0,1,0) in the gripper-base frame, effort 20.
FINGER_ORIGIN = np.array([[0.0, 0.04, 0.04], [0.0, -0.04, 0.04]], dtype=np.float64)
FINGER_AXIS = np.array([[0.0, -1.0, 0.0], [0.0, 1.0, 0.0]], dtype=np.float64)
FINGER_LIMIT = 0.035
FINGER_EFFORT = 20.0
FINGER_MASS = 0.636951
FINGER_INERTIA_SCALING = 3.0   # URDF <contact><inertia_scaling value="3.0"/>
GRIPPER_BASE_MASS = 0.636951   # iiwa_gripper_base_link (URDF:412)
# Mass of everything distal of the joint-7 force sensor: link_7 + gripper base
# + both fingers = 2.210853 kg. (The reference's commented-out compensation
# constant `22.10853` at kuka.py:252 is exactly this mass x g=10.)
EE_SUBTREE_MASS = LINK_MASS[7] + GRIPPER_BASE_MASS + 2.0 * FINGER_MASS
FINGER_TAB_OFFSET = np.array([[0.0, -0.005, 0.0], [0.0, 0.005, 0.0]], dtype=np.float64)
# Finger collision box half-extents: visual/collision box 0.025 x 0.01 x 0.08.
FINGER_HALF_EXTENTS = np.array([0.0125, 0.005, 0.04], dtype=np.float64)

# Robotiq-85 gripper constants surfaced by the reference robot layer
# (kuka.py:54-65).
ROBOTIQ_JOINT_LIMIT = 0.804
ROBOTIQ_GRASP_BLOCK_STATE = 0.545
ROBOTIQ_MIMIC_MULTIPLIER = np.array([1.0, 1.0, 1.0, -1.0, 1.0, -1.0], dtype=np.float64)
PARALLEL_JAW_GRASP_BLOCK_STATE = 0.02
PARALLEL_JAW_MIMIC_MULTIPLIER = np.array([1.0, 1.0], dtype=np.float64)

# ---------------------------------------------------------------------------
# Robotiq-85 mimic linkage (iiwa14_robotiq85.urdf:394-641).
#
# Kinematics: each finger is a parallelogram four-bar. The driven chain is
#   gripper_base -> inner_knuckle (revolute theta, mimic of finger_joint,
#                   urdf:513-527) -> finger_tip (revolute -theta, urdf:565-579)
# so the finger-tip link (the contact PAD) keeps a CONSTANT orientation
# relative to the gripper base and its position moves on a circle of radius
# |ROBOTIQ_ARM_T| around the inner-knuckle pivot. Every point of the pad
# therefore shares one velocity d(pad)/d(theta) — exactly the uniform
# "finger axis" abstraction the engine's parallel-jaw fingers already use,
# just theta-dependent.
#
# The gripper base frame B is link7 * (xyz (0,0,0.045), rpy (0,-pi/2,0))
# (urdf:394-398): x_B = +z_link7 (points out of the flange), y_B = y_link7,
# z_B = -x_link7. The linkage lives in the (x_B, y_B) plane; finger 1 is the
# +y_B side (its joint frames are flipped rpy (pi,0,0), urdf:417-421,513-517,
# which mirrors y and reverses the rotation sense, so both fingers close
# toward y_B = 0 as theta grows).
#
# In-base-plane coordinates (x_B, y_B) with s = +1 (finger 1) / -1 (finger 2):
#   inner-knuckle pivot  o_f = (0.06142, s*0.0127)          (urdf:517,525)
#   tip-joint arm        t(theta) = Rz(s*theta) applied to (0.04304, s*-0.0376)
#                                                           (urdf:569,577)
#   pad tab (face point) tab_f = o_f + t(theta) + (0.05, s*0.0075)
#                                                           (urdf:633-641)
# giving the scalar forms used by the engines:
#   tab_x(theta)    = 0.11142 + 0.04304*cos(theta) + 0.0376*sin(theta)
#   tab_y(theta, s) = s * (0.0127 + 0.0376*cos(theta) - 0.04304*sin(theta)
#                          - 0.0075)    # the tab sits toward the centreline
#   d tab_x/d theta = -0.04304*sin(theta) + 0.0376*cos(theta)
#   d tab_y/d theta = -s * (0.04304*cos(theta) + 0.0376*sin(theta))
# Checks: pad gap 2*|tab_y| = 85.7 mm at theta=0 (the "85" in Robotiq-85),
# 30.1 mm at the reference's grasp_block_state 0.545 (a 30 mm block), 0 at
# the 0.804 limit. Verified against the URDF chain in tests/test_robotiq.py.
ROBOTIQ_BASE_OFFSET = np.array([0.0, 0.0, 0.045], dtype=np.float64)
ROBOTIQ_INNER_X = 0.06142
ROBOTIQ_INNER_Y = 0.0127
ROBOTIQ_ARM_TX = 0.04303959807
ROBOTIQ_ARM_TY = 0.03759940821     # magnitude; applied as s*-ty
ROBOTIQ_TAB_X = 0.05
ROBOTIQ_TAB_Y = 0.0075             # applied as s*-ty (toward the centreline)
# Pad collision box half extents, expressed in LINK-7 axes (x_l7 = -z_B is
# the pad width, y_l7 = y_B the pad thickness, z_l7 = x_B the pad length):
# the finger-tip collision mesh is ~22 x 11 x 36 mm.
ROBOTIQ_PAD_HALF = np.array([0.011, 0.0055, 0.018], dtype=np.float64)
# Generalised closure-DoF dynamics: reflected inertia m*|t|^2 (with the same
# URDF contact inertia_scaling as the jaw fingers) and the reference's 50
# position-control effort on the driven joints (kuka.py:299), velocity cap 2
# rad/s (urdf:422).
ROBOTIQ_ARM_LEN = float(np.hypot(ROBOTIQ_ARM_TX, ROBOTIQ_ARM_TY))
ROBOTIQ_FINGER_INERTIA = FINGER_MASS * FINGER_INERTIA_SCALING * ROBOTIQ_ARM_LEN ** 2
ROBOTIQ_PD_FORCE = 50.0            # N*m about the closure DoF
ROBOTIQ_VEL_LIMIT = 2.0            # rad/s
# Distal subtree past the joint-7 force sensor (iiwa14_robotiq85.urdf
# inertials): link_7 0.3 + base 0.636951 + 2 x (knuckle 0.018491 + finger
# 0.027309 + inner knuckle 0.029951 + tip 0.019555).
ROBOTIQ_EE_SUBTREE_MASS = 0.3 + 0.636951 + 2.0 * (
    0.018491 + 0.027309 + 0.029951 + 0.019555)


def robotiq_pad_kinematics(theta, xp=np):
    """Pad tab position / pad box centre / closure velocity, LINK-7 frame.

    Args:
      theta: (..., 2) closure angles for (finger1, finger2), radians.
      xp: numpy or torch.
    Returns dict of (..., 2, 3) arrays: 'tab' (pad face reference points,
    the closeness endpoints), 'center' (pad collision box centres), 'vel'
    (world-frame-free d(pad)/d(theta), to be rotated by the link-7 quat).
    Mapping B -> link7: (x_B, y_B) -> (z_l7, y_l7), plus the base offset.
    """
    s = xp.asarray([1.0, -1.0], dtype=theta.dtype if hasattr(theta, 'dtype')
                   else np.float64)
    ct, st = xp.cos(theta), xp.sin(theta)
    tab_x = ROBOTIQ_INNER_X + ROBOTIQ_ARM_TX * ct + ROBOTIQ_ARM_TY * st \
        + ROBOTIQ_TAB_X
    tab_y = s * (ROBOTIQ_INNER_Y + ROBOTIQ_ARM_TY * ct
                 - ROBOTIQ_ARM_TX * st - ROBOTIQ_TAB_Y)
    dx = -ROBOTIQ_ARM_TX * st + ROBOTIQ_ARM_TY * ct
    dy = -s * (ROBOTIQ_ARM_TX * ct + ROBOTIQ_ARM_TY * st)
    zero = xp.zeros_like(tab_x)
    base_z = ROBOTIQ_BASE_OFFSET[2]
    tab = xp.stack([zero, tab_y, base_z + tab_x], axis=-1)
    # box centre: pushed out of the face by half the pad thickness
    center = xp.stack([zero, tab_y + s * ROBOTIQ_PAD_HALF[1],
                       base_z + tab_x], axis=-1)
    vel = xp.stack([zero, dy, dx], axis=-1)
    return {'tab': tab, 'center': center, 'vel': vel}

# Poses used by the reference robot layer (kuka.py:27-28).
KUKA_REST_POSE = np.array(
    [0.0, -0.5592432, 0.0, 1.733180, 0.0, -0.8501557, 0.0], dtype=np.float64)
KUKA_AWAY_POSE = np.array(
    [0.0, 0.5467089, 0.0, 4.518901, 0.0, 0.828478, 0.0], dtype=np.float64)

# IK null-space parameters (kuka.py:266-279; values from the upstream Bullet
# inverse_kinematics example).
IK_LOWER = np.array([-0.967, -2.0, -2.96, 0.19, -2.96, -2.09, -3.05], dtype=np.float64)
IK_UPPER = np.array([0.967, 2.0, 2.96, 2.29, 2.96, 2.09, 3.05], dtype=np.float64)
IK_RANGES = np.array([5.8, 4.0, 5.8, 4.0, 5.8, 4.0, 6.0], dtype=np.float64)
IK_MAX_ITERS = 40
IK_RESIDUAL_THRESHOLD = 1e-5

# PD drive constants (kuka.py:282-301).
ARM_PD_FORCE = 200.0
ARM_PD_POSITION_GAIN = 0.03
FINGER_PD_FORCE = 50.0
FINGER_PD_POSITION_GAIN = 0.03

# Fixed downward-pointing EE orientation, PyBullet xyzw (kuka.py:42) ->
# wxyz (0, 0, -1, 0): a 180-degree rotation about -y.
EE_FIXED_QUAT_WXYZ = np.array([0.0, 0.0, -1.0, 0.0], dtype=np.float64)

# Effective per-joint inertia (kg m^2) for the decoupled servo model: diagonal
# of the composite-rigid-body mass matrix at the rest pose, rounded to stable
# representative values. Used by ops/dynamics.py; precomputed offline so the
# step carries no URDF math.
ARM_EFFECTIVE_INERTIA = np.array(
    [1.8, 1.8, 0.9, 0.9, 0.25, 0.12, 0.05], dtype=np.float64)

# Arm collision spheres: sphere-chain approximation of the distal arm links
# (the reference loads the full link collision meshes and Bullet collides the
# whole arm, `robots/robot_bases.py:62-84`; radii follow the capsule chain in
# render/visuals.py:add_robot). Each sphere is attached to joint frame
# ARM_SPHERE_LINK (0-based, frame of iiwa_joint_{j+1}) at ARM_SPHERE_OFFSET in
# that frame; mid-segment spheres use the next joint's constant parent-frame
# origin (JOINT_ORIGIN_XYZ[j+1] / 2).
ARM_SPHERE_LINK = np.array([3, 3, 4, 4, 5, 6, 6], dtype=np.int32)
ARM_SPHERE_OFFSET = np.array([
    [0.0, 0.0, 0.0],                 # elbow (joint-4 origin)
    JOINT_ORIGIN_XYZ[4] / 2.0,       # mid upper-forearm
    [0.0, 0.0, 0.0],                 # joint-5 origin
    JOINT_ORIGIN_XYZ[5] / 2.0,       # mid lower-forearm
    [0.0, 0.0, 0.0],                 # wrist (joint-6 origin)
    [0.0, 0.0, 0.0],                 # joint-7 origin
    GRIPPER_BASE_OFFSET,             # gripper palm
], dtype=np.float64)
# Wrist r=0.043 / palm r=0.028: the real link-7 collar and gripper-base
# link are ~4 cm / ~3 cm wide; fatter guards interpenetrate the chest door
# HANDLE at the multi-step family's on-table start pose (tip (-0.52,0,0.176)
# puts the wrist centre 45 mm and the palm centre 28.5 mm from the handle's
# closest point), and a standing 1-5 mm graze there pumps a kN-scale wrist
# oscillation at spawn (tests/test_acceptance.py::test_chest_quiescence).
ARM_SPHERE_RADIUS = np.array(
    [0.065, 0.06, 0.06, 0.055, 0.055, 0.043, 0.028], dtype=np.float64)
