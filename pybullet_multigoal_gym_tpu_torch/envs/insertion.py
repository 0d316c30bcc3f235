"""6-DoF insertion family: insertion, batched.

Counterpart of `pybullet_multigoal_gym_tpu/envs/insertion.py`
(`KukaInsertionEnv`), with the same observation, goal and reward
contracts: end-effector control of position and orientation (xyz, a ZYZ
Euler accumulator, grip: `KukaEnvBase.step_decode_pre`), the EE force
sensor (`robot.robot_state`), optional Gaussian state noise, the objects'
poses as auxiliary state and dense per-subtask rewards. The scene is a
free upright rectangle and a pinned slot (`ops/scene.py:insertion_scene`,
bodies in that order; the env orders its objects slot, rectangle). One
step runs K1 at 8 iterations toward the accumulator's orientation, then K3
for 100 substeps (`envs/vec_env.py`), the JAX package's batched path; its
per-env XLA `step` solves IK at the model's default 40 iterations instead.

As in the JAX package, the orientation accumulator starts at the ZYZ
angles of the fixed downward tip orientation, so the first target is the
actual downward pose.
"""

import math

import numpy as np
import torch

from pybullet_multigoal_gym_tpu_torch.config import EnvConfig
from pybullet_multigoal_gym_tpu_torch.envs import core
from pybullet_multigoal_gym_tpu_torch.envs import robot as R
from pybullet_multigoal_gym_tpu_torch.envs.single_step import F32, KukaEnvBase
from pybullet_multigoal_gym_tpu_torch.maths import quat as quatm
from pybullet_multigoal_gym_tpu_torch.ops import dynamics as D
from pybullet_multigoal_gym_tpu_torch.ops import scene as S
from pybullet_multigoal_gym_tpu_torch.ops.cuda_multibody import (
    CudaMultiBodyEngine)
from pybullet_multigoal_gym_tpu_torch.utils.tensors import const

# ZYZ Euler angles of the fixed downward EE orientation (wxyz (0, 0, -1, 0))
DOWN_ZYZ = np.array([np.pi, np.pi, -np.pi], np.float32)
# object_initial_pos heights (kuka_insertion_base_env.py:54-58)
OBJ_Z = {'slot': 0.03, 'rectangle': 0.06}
# the slot_target frame, slot link 3 at (-0.03, 0, 0): the pocket's centre
# (insertion/slot.urdf:133-137)
SLOT_TARGET = (-0.03, 0.0, 0.0)
# the rectangle's grasp_target frame, +0.03 z (insertion/rectangle.urdf:34-38)
GRASP_TARGET = (0.0, 0.0, 0.03)
STATE_NOISE_STD = 0.05


class KukaInsertionEnv(KukaEnvBase):
    """insertion (`envs/task_envs/kuka_insertion_envs.py`) for a batch of
    environments on ``device``."""

    def __init__(self, cfg: EnvConfig, device: torch.device):
        if cfg.family != 'insertion':
            raise NotImplementedError('family %r comes with a later slice of '
                                      'the port' % cfg.family)
        super().__init__(cfg, device)
        self.object_keys = cfg.manipulated_object_keys  # slot, rectangle
        self.goal_obj_idx = self.object_keys.index(cfg.goal_object_key)
        self.spec = S.insertion_scene()
        self.nb = self.spec.n_bodies
        self.scene = D.multibody_consts(self.spec,
                                        ik_workspace=self.ik_workspace)
        self.engine = CudaMultiBodyEngine(self.scene)

    @staticmethod
    def _body_index(key):
        """The scene's body of an env object: 0 the rectangle, 1 the
        slot."""
        return 0 if key == 'rectangle' else 1

    @property
    def goal_dim(self):
        return 6

    # ------------------------------------------------------------------ reset
    def reset(self, n: int, gen: torch.Generator):
        """n fresh episodes drawn from ``gen``: (EnvState, obs). The slot
        and the rectangle more than 0.06 m apart and from the gripper
        start, each turned by a yaw in [-pi, pi), upright (JAX
        `insertion.py:59-82`)."""
        xy = core.sample_block_positions(
            gen, n, len(self.object_keys), self.object_lower[:2],
            self.object_upper[:2], self.tip_initial[:2], 0.0)[..., :2]
        yaws = (torch.rand((n, len(self.object_keys)), generator=gen,
                           device=self.device) * 2.0 - 1.0) * math.pi
        quats = quatm.yaw_quat_zyz(yaws)
        body_pos = torch.zeros((n, self.nb, 3), dtype=F32, device=self.device)
        body_quat = torch.zeros((n, self.nb, 4), dtype=F32, device=self.device)
        for i, key in enumerate(self.object_keys):
            b = self._body_index(key)
            body_pos[:, b, :2] = xy[:, i]
            body_pos[:, b, 2] = OBJ_Z[key]
            body_quat[:, b] = quats[:, i]
        state = self._base_env_state(
            self._reset_phys(n, body_pos, body_quat),
            torch.zeros((n, self.goal_dim), dtype=F32, device=self.device))
        state = state._replace(ee_target_rot=const(DOWN_ZYZ, body_pos)
                               .expand(n, 3).clone())
        state = self._generate_goal(state)
        return state, self._get_obs(state, gen)

    # ------------------------------------------------------------------ goals
    def _slot_target(self, ph):
        """The slot_target frame's position and the slot's ZYZ angles."""
        b = self._body_index('slot')
        squat = ph.body_quat[:, b]
        tgt = ph.body_pos[:, b] + quatm.rotate(squat, const(SLOT_TARGET,
                                                            squat))
        return tgt, quatm.quat_to_euler_zyz(squat)

    def _generate_goal(self, state: core.EnvState):
        """The slot_target frame at the rectangle's initial height, with the
        slot's ZYZ angles (kuka_insertion_envs.py:25-30)."""
        tgt, euler = self._slot_target(state.phys)
        z = tgt.new_full((tgt.shape[0], 1), OBJ_Z['rectangle'])
        return state._replace(desired_goal=torch.cat([tgt[:, :2], z, euler],
                                                     -1))

    # ------------------------------------------------------------------- step
    def step_finish(self, state: core.EnvState, gen=None):
        """Observation and reward after the control step; ``gen`` draws
        the state noise where the config asks for it."""
        cfg = self.cfg
        obs = self._get_obs(state, gen)
        reward, achieved = core.binary_or_dense_reward(
            obs['achieved_goal'], obs['desired_goal'],
            cfg.distance_threshold, cfg.binary_reward)
        return state, obs, reward, achieved

    # -------------------------------------------------------------------- obs
    def _get_obs(self, state: core.EnvState, gen=None):
        """Field for field the JAX package's insertion observation
        (`kuka_insertion_base_env.py:142-208`); with ``cfg.state_noise``
        the policy state, less its finger closeness, gains N(0, 0.05)
        noise drawn from ``gen``."""
        ph = state.phys
        rs = R.robot_state(ph.q, ph.qd, ph.fq, ph.fqd, True,
                           ee_contact_force=ph.ee_contact_force)
        gripper_xyz, fx = rs['gripper_xyz'], rs['ee_joint_force']
        state_vec = torch.cat([
            gripper_xyz, rs['gripper_rpy'], rs['gripper_vel_xyz'],
            rs['gripper_vel_rpy'], rs['gripper_finger_vel'],
            rs['joint_poses'], fx, rs['gripper_finger_closeness']], -1)
        policy_state = torch.cat([gripper_xyz, rs['gripper_rpy'],
                                  rs['joint_poses'], fx], -1)
        if self.cfg.state_noise:
            policy_state = policy_state + torch.randn(
                policy_state.shape, generator=gen,
                device=policy_state.device) * STATE_NOISE_STD
        policy_state = torch.cat([policy_state,
                                  rs['gripper_finger_closeness']], -1)
        object_state, achieved = [], None
        for i, key in enumerate(self.object_keys):
            b = self._body_index(key)
            pose = torch.cat([ph.body_pos[:, b],
                              quatm.quat_to_euler_zyz(ph.body_quat[:, b])], -1)
            object_state.append(pose)
            if i == self.goal_obj_idx:
                achieved = pose
        return {'observation': state_vec,
                'policy_state': policy_state,
                'auxiliary_task_state': torch.cat(object_state, -1),
                'achieved_goal': achieved,
                'desired_goal': state.desired_goal,
                'subtask_rewards': self._compute_subtask_reward(
                    state, gripper_xyz)}

    def _compute_subtask_reward(self, state: core.EnvState, gripper_xyz):
        """Dense pick_up / reach / insert rewards, their done flags and
        goal pairs (`kuka_insertion_base_env.py:210-254`)."""
        ph = state.phys
        thr = self.cfg.distance_threshold
        rb = self._body_index('rectangle')
        obj_xyz = ph.body_pos[:, rb]
        obj_quat = ph.body_quat[:, rb]
        obj_euler = quatm.quat_to_euler_zyz(obj_quat)
        grasp_xyz = obj_xyz + quatm.rotate(obj_quat,
                                           const(GRASP_TARGET, obj_quat))
        slot_xyz, slot_euler = self._slot_target(ph)
        norm = torch.linalg.vector_norm
        d_pick = norm(grasp_xyz - gripper_xyz, dim=-1) + torch.abs(
            0.15 - obj_xyz[:, 2])
        reach_t = slot_xyz + const([0.0, 0.0, 0.06], slot_xyz)
        d_euler = norm(obj_euler - slot_euler, dim=-1)
        d_reach = norm(obj_xyz - reach_t, dim=-1) + d_euler
        insert_t = slot_xyz + const([0.0, 0.0, 0.03], slot_xyz)
        d_insert = norm(obj_xyz - insert_t, dim=-1) + d_euler
        obj_pose = torch.cat([obj_xyz, obj_euler], -1)
        return {
            'pick_up': torch.clamp(-d_pick, -15.0, 0.0),
            'pick_up_done': d_pick < thr,
            'pick_up_desired_goal': torch.cat(
                [grasp_xyz, grasp_xyz.new_full((grasp_xyz.shape[0], 1),
                                               0.15)], -1),
            'pick_up_achieved_goal': torch.cat([gripper_xyz, obj_xyz[:, 2:3]],
                                               -1),
            'reach': torch.clamp(-d_reach, -15.0, 0.0),
            'reach_done': d_reach < thr,
            'reach_desired_goal': torch.cat([reach_t, slot_euler], -1),
            'reach_achieved_goal': obj_pose,
            'insert': torch.clamp(-d_insert, -15.0, 0.0),
            'insert_done': d_insert < thr,
            'insert_desired_goal': torch.cat([insert_t, slot_euler], -1),
            'insert_achieved_goal': obj_pose,
        }
