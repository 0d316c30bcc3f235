"""Push-primitive family: primitive_push_assemble and primitive_push_reach,
batched.

Counterpart of `pybullet_multigoal_gym_tpu/envs/shape_assemble.py`
(`KukaPrimitiveEnv`), with the same observation, goal and reward
contracts. One env action executes a whole push primitive: the action
decodes into 4 tip waypoints (``step_decode_waypoints``), each leg is cut
into ``INTERP_K`` straight-line sub-targets, and for each of the 20
sub-targets the arm solves IK (kernel K1 at ``PRIMITIVE_IK_ITERS``
iterations, warm-started from the current configuration) and runs
``SUBSTEPS_PER_TARGET`` substeps on the multi-body engine (kernel K3) with
the fingers held open (``execute_primitive``); the arm is teleported to
rest before and after. That is the JAX package's batched path
(`execute_primitive_batched`), which its vec env runs; its per-env XLA
`step` solves IK at the model's default 40 iterations instead.
"""

import math

import numpy as np
import torch

from pybullet_multigoal_gym_tpu_torch.config import EnvConfig
from pybullet_multigoal_gym_tpu_torch.envs import core
from pybullet_multigoal_gym_tpu_torch.envs.single_step import F32, KukaEnvBase
from pybullet_multigoal_gym_tpu_torch.maths import quat as quatm
from pybullet_multigoal_gym_tpu_torch.ops import dynamics as D
from pybullet_multigoal_gym_tpu_torch.ops import scene as S
from pybullet_multigoal_gym_tpu_torch.ops.cuda_ik import CudaIK
from pybullet_multigoal_gym_tpu_torch.ops.cuda_multibody import (
    CudaMultiBodyEngine)
from pybullet_multigoal_gym_tpu_torch.utils.tensors import const

# workspace range of the push primitive (kuka_shape_assemble_base_env.py:70-73)
WORKSPACE_UPPER_XY = np.array([-0.405, 0.175], np.float32)
WORKSPACE_LOWER_XY = np.array([-0.755, -0.175], np.float32)
RESOLUTION = 0.0015625          # 0.35 / 224 m per pixel
PUSH_LENGTH = 0.1               # kuka.py:87
NUM_ANGLES = 20                 # kuka.py:90
# sub-targets per waypoint leg (JAX `KukaPrimitiveEnv.INTERP_K`): the 20
# sim calls of a leg are cut into 5 hops of 4 (80 substeps each)
INTERP_K = 5
SUBSTEPS_PER_TARGET = 20 // INTERP_K * D.SUBSTEPS_PER_SIM
# waypoint jumps are ~0.1 m: more IK iterations than the warm-started
# per-step IK (JAX `get_pallas_ik_primitive`)
PRIMITIVE_IK_ITERS = 16


class KukaPrimitiveEnv(KukaEnvBase):
    """primitive_push_assemble (slot and cube) and primitive_push_reach
    (rectangle) (`envs/task_envs/kuka_shape_assemble_envs.py`) for a batch
    of environments on ``device``."""

    def __init__(self, cfg: EnvConfig, device: torch.device):
        if cfg.family != 'shape_assemble':
            raise NotImplementedError('family %r comes with a later slice of '
                                      'the port' % cfg.family)
        super().__init__(cfg, device)
        rng = WORKSPACE_UPPER_XY - WORKSPACE_LOWER_XY
        # int((range + 1e-4) // resolution) (kuka.py:92-94)
        self.action_map_width = int((rng[0] + 0.0001) // RESOLUTION)
        self.action_map_height = int((rng[1] + 0.0001) // RESOLUTION)
        self.object_keys = cfg.manipulated_object_keys
        self.goal_obj_idx = self.object_keys.index(cfg.goal_object_key)
        # object_initial_pos (kuka_shape_assemble_base_env.py:55-61)
        self.obj_z = 0.035
        self.nb = len(self.object_keys)
        self.spec = S.shape_assemble_scene(self.object_keys)
        self.scene = D.multibody_consts(self.spec,
                                        ik_workspace=self.ik_workspace)
        self.engine = CudaMultiBodyEngine(self.scene)
        self.ik = CudaIK(num_iters=PRIMITIVE_IK_ITERS)

    @property
    def goal_dim(self):
        return 6 if self.cfg.orientation_informed_goal else 3

    # ------------------------------------------------------------------ reset
    def reset(self, n: int, gen: torch.Generator):
        """n fresh episodes drawn from ``gen``: (EnvState, obs). Objects
        more than 0.06 m apart and from the gripper start, each with a
        random yaw."""
        pos = core.sample_block_positions(
            gen, n, self.nb, self.object_lower[:2], self.object_upper[:2],
            self.tip_initial[:2], self.obj_z)
        yaws = (torch.rand((n, self.nb), generator=gen, device=self.device)
                * 2.0 - 1.0) * math.pi
        phys = self._reset_phys(n, pos, quatm.yaw_quat_zyz(yaws))
        state = self._base_env_state(
            phys, torch.zeros((n, self.goal_dim), dtype=F32,
                              device=self.device))
        state = self._generate_goal(state, gen)
        return state, self._get_obs(state)

    # ------------------------------------------------------------------ goals
    def _generate_goal(self, state: core.EnvState, gen: torch.Generator):
        """assemble: the slot-target frame, (-0.03, 0, 0) in the slot's
        frame (kuka_shape_assemble_envs.py:25-30). reach: a rejection-sampled
        position more than 0.06 m from the object, drawn in the target box
        before its height is set to the object's (as the reference does),
        with a random yaw (:76-91)."""
        n = state.phys.q.shape[0]
        if self.cfg.task == 'primitive_push_assemble':
            slot = self.object_keys.index('slot')
            squat = state.phys.body_quat[:, slot]
            tgt = state.phys.body_pos[:, slot] + quatm.rotate(
                squat, const([-0.03, 0.0, 0.0], squat))
            euler = quatm.quat_to_euler_zyz(squat)
        else:
            obj = state.phys.body_pos[:, self.goal_obj_idx]
            tgt = core.rejection_uniform(
                gen, self.target_lower, self.target_upper,
                lambda g: torch.linalg.vector_norm(
                    g - obj[:, None], dim=-1) > 0.06, n)
            tgt[:, 2] = self.obj_z
            yaw = (torch.rand((n,), generator=gen, device=self.device)
                   * 2.0 - 1.0) * math.pi
            euler = quatm.quat_to_euler_zyz(quatm.yaw_quat_zyz(yaw))
        return state._replace(desired_goal=torch.cat([tgt, euler], -1))

    # ------------------------------------------------------------------- step
    def step_decode_waypoints(self, action):
        """(N, 3) actions -> the 4 push-primitive tip waypoints (N, 4, 3)
        (kuka.py:174-202): discrete_push takes (angle index, px, py) on the
        action map, continuous_push (x, y, angle) in [-1, 1]."""
        a = action.to(F32)
        lower = const(WORKSPACE_LOWER_XY, a)
        upper = const(WORKSPACE_UPPER_XY, a)
        rng = upper - lower
        if self.cfg.primitive == 'discrete_push':
            start_x = a[:, 1] * RESOLUTION + lower[0]
            start_y = a[:, 2] * RESOLUTION + lower[1]
            angle = 2.0 * math.pi / NUM_ANGLES * a[:, 0]
        else:
            a = torch.clamp(a, -1.0, 1.0)
            start_x = lower[0] + rng[0] * (a[:, 0] + 1.0) / 2.0
            start_y = lower[1] + rng[1] * (a[:, 1] + 1.0) / 2.0
            angle = a[:, 2] * math.pi / 2.0
        end_x = torch.clamp(start_x + torch.cos(angle) * PUSH_LENGTH,
                            lower[0], upper[0])
        end_y = torch.clamp(start_y + torch.sin(angle) * PUSH_LENGTH,
                            lower[1], upper[1])
        z_hi = torch.full_like(start_x, self.cfg.table_surface_z + 0.1)
        z_lo = torch.full_like(start_x, self.cfg.table_surface_z + 0.01)
        return torch.stack([
            torch.stack([start_x, start_y, z_hi], -1),
            torch.stack([start_x, start_y, z_lo], -1),
            torch.stack([end_x, end_y, z_lo], -1),
            torch.stack([end_x, end_y, z_hi], -1)], 1)

    def _interp_waypoints(self, wps):
        """(N, 4, 3) -> (N, 4 INTERP_K, 3): straight-line sub-targets from
        the tip's rest position through the waypoints."""
        tip0 = self._tip_rest.expand(wps[:, :1].shape)
        prev = torch.cat([tip0, wps[:, :-1]], 1)
        frac = (torch.arange(INTERP_K, dtype=F32, device=wps.device) + 1.0
                ) / INTERP_K
        seg = prev[:, :, None] + (wps - prev)[:, :, None] * frac[:, None]
        return seg.reshape(wps.shape[0], 4 * INTERP_K, 3)

    def execute_primitive(self, phys: D.PhysicsState, wps):
        """One push primitive per env (kuka.py:303-312, JAX
        `execute_primitive_batched`): teleport the arm to rest, then for
        each sub-target one IK solve (K1) and SUBSTEPS_PER_TARGET substeps
        (K3) with the fingers held open, then teleport back to rest."""
        n = phys.q.shape[0]
        rest = self._rest.expand(n, 7)
        zeros = torch.zeros((n,), dtype=F32, device=self.device)
        controls = dict(
            f_target=torch.full((n, 2), self.gripper_abs_joint_limit,
                                dtype=F32, device=self.device),
            door_motor_on=zeros > 0, door_target=zeros)
        phys = phys._replace(q=rest.clone(), qd=torch.zeros_like(phys.qd))
        sub = self._interp_waypoints(wps)
        for w in range(sub.shape[1]):
            q_t = self.ik.solve(sub[:, w].contiguous(), q_init=phys.q,
                                rest_pose=rest)
            phys = self.engine.control_step(
                phys, D.Controls(q_target=q_t, **controls),
                n_substeps=SUBSTEPS_PER_TARGET)
        return phys._replace(q=rest.clone(), qd=torch.zeros_like(phys.qd))

    def step_finish(self, state: core.EnvState, gen=None):
        """Observation and reward after the primitive; primitive_push_assemble
        regenerates its goal (the slot's frame) first."""
        cfg = self.cfg
        if cfg.regenerate_goal_when_step:
            state = self._generate_goal(state, None)
        obs = self._get_obs(state)
        reward, achieved = core.binary_or_dense_reward(
            obs['achieved_goal'], obs['desired_goal'],
            cfg.distance_threshold, cfg.binary_reward)
        return state, obs, reward, achieved

    # -------------------------------------------------------------------- obs
    def _get_obs(self, state: core.EnvState):
        """Object poses with ZYZ Euler angles; the achieved goal is the goal
        object's pose (`kuka_shape_assemble_base_env.py:145-202`)."""
        ph = state.phys
        parts, achieved = [], []
        for i in range(self.nb):
            xyz = ph.body_pos[:, i]
            euler = quatm.quat_to_euler_zyz(ph.body_quat[:, i])
            parts += [xyz, euler]
            if i == self.goal_obj_idx:
                achieved.append(xyz)
                if self.cfg.orientation_informed_goal:
                    achieved.append(euler)
        state_vec = torch.cat(parts, -1)
        return {'observation': state_vec,
                'policy_state': state_vec,
                'achieved_goal': torch.cat(achieved, -1),
                'desired_goal': state.desired_goal}
