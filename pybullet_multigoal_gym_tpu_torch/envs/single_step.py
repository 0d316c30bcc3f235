"""Single-step task family: Reach / Push / PickAndPlace / Slide, batched.

Counterpart of `pybullet_multigoal_gym_tpu/envs/single_step.py` with the
same observation, goal and reward contracts. Every method works on a whole
batch (leading env axis) on the env's device. The step is split as in the
JAX package: ``step_decode_pre`` (action decoding), then the vec wrapper runs
IK (kernel K1, `ops/cuda_ik.py`) and the control step (kernel K2,
`ops/cuda_engine.py`), then ``step_finish`` (observation and reward).
With the Robotiq-85 gripper the finger joints are the linkage's closure
angles in [0, 0.804] rad, the tip lies 0.18 m out along link 7's z, and
the rest pose is solved for that tip.
"""

import numpy as np
import torch

from pybullet_multigoal_gym_tpu_torch.config import EnvConfig
from pybullet_multigoal_gym_tpu_torch.envs import core
from pybullet_multigoal_gym_tpu_torch.envs import robot as R
from pybullet_multigoal_gym_tpu_torch.maths import quat as quatm
from pybullet_multigoal_gym_tpu_torch.model import kuka_model as KM
from pybullet_multigoal_gym_tpu_torch.ops import dynamics as D
from pybullet_multigoal_gym_tpu_torch.ops import fk, ik
from pybullet_multigoal_gym_tpu_torch.ops import scene as S
from pybullet_multigoal_gym_tpu_torch.ops.cuda_engine import CudaEngine
from pybullet_multigoal_gym_tpu_torch.ops.cuda_ik import CudaIK

F32 = torch.float32
# in-step IK is warm-started (the EE target moves <= 1 cm per action), so 8
# DLS iterations suffice; the model's 40 is the cold-start cap
IK_ITERS_IN_STEP = 8


class KukaEnvBase:
    """What every family shares (JAX `single_step.py:26-205`): workspace
    bounds, rest pose, action decoding, the arm targets (kernel K1) and the
    reset state, for a batch of environments on ``device``."""

    def __init__(self, cfg: EnvConfig, device: torch.device):
        if cfg.gripper == 'robotiq85' and (
                cfg.has_chest
                or cfg.family not in ('single_step', 'multi_step')):
            raise NotImplementedError(
                'the Robotiq-85 gripper on the push primitives, insertion and '
                'the chest comes with a later slice of the port, the next one')
        if cfg.image_observation or cfg.point_cloud or cfg.goal_image:
            raise NotImplementedError('image and point-cloud observations '
                                      'come with a later slice of the port')
        self.cfg = cfg
        self.device = device
        # EE control only feeds the servo IK solutions inside the workspace
        # box, which lets the engine cull unreachable arm-sphere lanes
        self.ik_workspace = not cfg.joint_control
        tip_init = np.array([-0.52, 0.0, 0.25])
        if cfg.end_effector_start_on_table:
            tip_init[2] = cfg.table_surface_z + 0.001
        self.tip_initial = tip_init
        self.ee_upper = np.array([-0.37, 0.20, 0.55])
        self.ee_lower = np.array([-0.67, -0.20, cfg.table_surface_z])
        obj_r, tgt_r = cfg.obj_range, cfg.target_range
        self.object_lower = tip_init - obj_r
        self.object_lower[0] += 0.03
        self.object_upper = tip_init + obj_r
        self.object_upper[0] -= 0.03
        self.target_lower = tip_init - tgt_r
        self.target_lower[0] += 0.03
        self.target_lower[2] = self.ee_lower[2]
        self.target_upper = tip_init + tgt_r
        self.target_upper[0] -= 0.03
        if cfg.table_type == 'long_table':
            # slide's goals lie beyond the workspace, on the long table
            # (kuka_single_step_base_env.py:66-69)
            self.target_lower[0] -= 0.4
            self.target_upper[0] -= 0.4
        # the gripper's joint-limit surface (JAX `single_step.py:59-70`):
        # the grip action's scale and the reset's finger state; the grasp
        # state and the finger scale are kept for the render slice
        robotiq = cfg.gripper == 'robotiq85'
        self.gripper_abs_joint_limit = (KM.ROBOTIQ_JOINT_LIMIT if robotiq
                                        else KM.FINGER_LIMIT)
        self.gripper_grasp_block_state = (
            KM.ROBOTIQ_GRASP_BLOCK_STATE if robotiq
            else KM.PARALLEL_JAW_GRASP_BLOCK_STATE)
        self.finger_scale = (KM.FINGER_LIMIT / KM.ROBOTIQ_JOINT_LIMIT
                             if robotiq else 1.0)
        self.block_z = 0.175
        # rest pose: IK from the canonical pose to the gripper's tip start,
        # on the CPU so every device starts from the same numbers
        rest = ik.solve(torch.tensor(tip_init, dtype=F32),
                        q_init=torch.tensor(KM.KUKA_REST_POSE, dtype=F32),
                        gripper=cfg.gripper)
        self.rest_pose = rest.numpy()
        self.tip_rest = fk.tip_pose(rest, cfg.gripper)[0].numpy()
        self.ik = CudaIK(num_iters=IK_ITERS_IN_STEP, gripper=cfg.gripper)

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)
        self._rest = t(self.rest_pose)
        self._tip_rest = t(self.tip_rest)
        self._tip_init = t(tip_init)
        self._ee_lower, self._ee_upper = t(self.ee_lower), t(self.ee_upper)

    def _reset_phys(self, n, body_pos, body_quat=None):
        """Resting physics for n envs: the rest pose, the fingers at the
        joint limit (closed, as the reference resets them), the bodies at
        ``body_pos`` (n, NB, 3), upright or turned to ``body_quat`` (n, NB,
        4)."""
        return D.init_state(n, self.nb, q=self._rest, body_pos=body_pos,
                            body_quat=body_quat,
                            fq=self.gripper_abs_joint_limit,
                            device=self.device)

    def _base_env_state(self, phys, desired_goal, nc: int = 1):
        n, nb = phys.q.shape[0], self.nb
        gd = desired_goal.shape[-1]
        kw = dict(device=self.device)
        i32 = torch.int32
        prob = torch.zeros((n, max(nc, 1)), dtype=F32, **kw)
        prob[:, 0] = 1.0
        return core.EnvState(
            phys=phys,
            steps=torch.zeros((n,), dtype=i32, **kw),
            ee_target=self._tip_rest.expand(n, 3).clone(),
            ee_target_rot=torch.zeros((n, 3), dtype=F32, **kw),
            joint_target=self._rest.expand(n, 7).clone(),
            desired_goal=desired_goal,
            sub_goals=torch.zeros((n, max(self.cfg.num_steps, 1), gd),
                                  dtype=F32, **kw),
            sub_goal_ind=torch.full((n,), -1, dtype=i32, **kw),
            target_xyzs=torch.zeros((n, nb, 3), dtype=F32, **kw),
            block_order=torch.arange(nb, dtype=i32, **kw).expand(n, nb).clone(),
            curriculum_level=torch.zeros((n,), dtype=i32, **kw),
            ind_block_to_move=torch.zeros((n, nb), dtype=torch.bool, **kw),
            curriculum_prob=prob,
            goals_generated=torch.zeros((n, max(nc, 1)), dtype=F32, **kw),
            curriculum_update=torch.zeros((n,), dtype=torch.bool, **kw),
            curriculum_goal_step=torch.full((n,), 50, dtype=i32, **kw),
            door_hold_open=torch.zeros((n,), dtype=torch.bool, **kw),
            spawn_body_pos=phys.body_pos.clone())

    # ------------------------------------------------------------------- step
    def step_decode_pre(self, state: core.EnvState, action):
        """Decode a batch of actions without the IK solve: returns the state
        with the new EE (or joint) target, and the finger targets (N, 2)."""
        cfg = self.cfg
        a = torch.clamp(action.to(F32), -1.0, 1.0)
        n = a.shape[0]
        limit = self.gripper_abs_joint_limit
        if cfg.grasping:
            grip = (a[:, -1] + 1.0) * (limit / 2.0)
        else:
            grip = a.new_full((n,), limit)
        f_target = grip[:, None].expand(n, 2)
        if cfg.joint_control:
            state = state._replace(
                joint_target=state.joint_target + a[:, :7] * 0.05)
        else:
            state = state._replace(ee_target=torch.clamp(
                state.ee_target + a[:, :3] * 0.01, self._ee_lower,
                self._ee_upper))
            if cfg.end_effector_rotation_control:
                # the ZYZ Euler accumulator of the EE orientation target
                # (kuka.py:204-220)
                state = state._replace(
                    ee_target_rot=state.ee_target_rot + a[:, 3:6] * 0.05)
        return state, f_target

    def arm_targets(self, state: core.EnvState):
        """Joint targets of the arm servo: IK (kernel K1) toward the EE
        target, warm-started from the current configuration, or the joint
        target under joint control. Under EE rotation control the IK's
        target orientation is the ZYZ accumulator's quaternion, else the
        fixed downward one."""
        if self.cfg.joint_control:
            return state.joint_target
        n = state.ee_target.shape[0]
        target_quat = (quatm.euler_zyz_to_quat(state.ee_target_rot)
                       if self.cfg.end_effector_rotation_control else None)
        return self.ik.solve(state.ee_target, target_quat=target_quat,
                             q_init=state.phys.q,
                             rest_pose=self._rest.expand(n, 7))


class KukaSingleStepEnv(KukaEnvBase):
    """Reach / Push / PickAndPlace / Slide
    (`envs/task_envs/kuka_single_step_envs.py`) for a batch of environments
    on ``device``. Slide's puck is a cylinder on the long table (friction
    0.05), resting 5 mm lower than the block."""

    def __init__(self, cfg: EnvConfig, device: torch.device):
        if cfg.family != 'single_step':
            raise NotImplementedError('family %r comes with a later slice of '
                                      'the port' % cfg.family)
        super().__init__(cfg, device)
        # object_initial_pos['block'][2] (kuka_single_step_base_env.py:50-56)
        self.block_z = 0.170 if cfg.table_type == 'long_table' else 0.175
        self.spec = S.single_step_scene(cfg.has_obj, cfg.table_type)
        self.nb = max(self.spec.n_bodies, 1)
        self.scene = D.scene_consts(self.spec, ik_workspace=self.ik_workspace,
                                    gripper=cfg.gripper)
        self.engine = CudaEngine(self.scene)

    # ------------------------------------------------------------------ reset
    def reset(self, n: int, gen: torch.Generator):
        """n fresh episodes drawn from ``gen``: (EnvState, obs)."""
        cfg = self.cfg
        tip_init = self._tip_init
        if cfg.has_obj:
            # object >= 0.1 m (xy) from the gripper start
            obj_xy = core.rejection_uniform(
                gen, self.object_lower[:2], self.object_upper[:2],
                lambda xy: torch.linalg.vector_norm(
                    xy - tip_init[:2], dim=-1) > 0.1, n)
            obj_xyz = torch.cat([obj_xy, obj_xy.new_full((n, 1),
                                                          self.block_z)], -1)
            body_pos = obj_xyz[:, None]
            center = obj_xyz
        else:
            body_pos = torch.zeros((n, self.nb, 3), dtype=F32,
                                   device=self.device)
            center = tip_init.expand(n, 3)
        # goal >= 0.1 m from the object (or the gripper start for reach)
        goal = core.rejection_uniform(
            gen, self.target_lower, self.target_upper,
            lambda g: torch.linalg.vector_norm(
                g - center[:, None], dim=-1) > 0.1, n)
        if not cfg.target_in_the_air:
            goal[:, 2] = self.block_z
        elif cfg.grasping:
            # half of the targets lie on the table
            on_table = torch.rand((n,), generator=gen, device=self.device) >= 0.5
            goal[:, 2] = torch.where(on_table, self.block_z, goal[:, 2])
        state = self._base_env_state(self._reset_phys(n, body_pos), goal)
        return state, self._get_obs(state)

    # ------------------------------------------------------------------- step
    def step_finish(self, state: core.EnvState, gen=None):
        cfg = self.cfg
        obs = self._get_obs(state)
        reward, achieved = core.binary_or_dense_reward(
            obs['achieved_goal'], obs['desired_goal'],
            cfg.distance_threshold, cfg.binary_reward)
        return state, obs, reward, achieved

    # -------------------------------------------------------------------- obs
    def _get_obs(self, state: core.EnvState):
        """Field for field the JAX package's single-step observation."""
        cfg = self.cfg
        ph = state.phys
        rs = R.robot_state(ph.q, ph.qd, ph.fq, ph.fqd, cfg.grasping,
                           gripper=cfg.gripper)
        gripper_xyz = rs['gripper_xyz']
        policy_state = state_vec = gripper_xyz
        achieved_goal = gripper_xyz
        if cfg.has_obj:
            block_xyz = ph.body_pos[:, 0]
            block_rel_xyz = gripper_xyz - block_xyz
            block_vel_xyz = ph.body_linvel[:, 0]
            block_vel_rpy = ph.body_angvel[:, 0]
            block_rel_vel_xyz = rs['gripper_vel_xyz'] - block_vel_xyz
            block_rel_vel_rpy = rs['gripper_vel_rpy'] - block_vel_rpy
            achieved_goal = block_xyz
            state_vec = torch.cat([
                gripper_xyz, block_xyz, rs['gripper_finger_closeness'],
                block_rel_xyz, rs['gripper_vel_xyz'], rs['gripper_finger_vel'],
                block_rel_vel_xyz, block_rel_vel_rpy], -1)
            policy_state = torch.cat([
                gripper_xyz, rs['gripper_finger_closeness'], block_rel_xyz],
                -1)
        if cfg.joint_control:
            state_vec = torch.cat([rs['joint_poses'], state_vec], -1)
            policy_state = torch.cat([rs['joint_poses'], policy_state], -1)
        return {'observation': state_vec,
                'policy_state': policy_state,
                'achieved_goal': achieved_goal,
                'desired_goal': state.desired_goal}
