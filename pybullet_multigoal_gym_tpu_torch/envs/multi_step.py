"""Multi-block long-horizon family: BlockStack, BlockRearrange,
ChestPickAndPlace and ChestPush, batched.

Counterpart of `pybullet_multigoal_gym_tpu/envs/multi_step.py` with the same
observation and goal layouts, curriculum bookkeeping, task-decomposition
sub-goals and the chest door's hold-open latch. Every method works on a
whole batch (leading env axis) on the env's device; random draws come from
the env's `torch.Generator`. The step is split as in the single-step family:
``step_decode_pre``, then the vec wrapper runs IK (kernel K1) and the
control step (kernel K3, `ops/cuda_multibody.py`, with the door's motor on
where the latch is set), then ``step_finish``, which also regenerates the
goal from the blocks' positions and sets the latch.
"""

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

# door keypoint offsets in the door joint frame, per sliding door kind
# (chest_*.urdf keypoint joints): left, right, handle; the revolving door no
# task builds (`ops/dynamics.py:multibody_consts` raises for it)
_KEYPOINTS = {
    'up_sliding': np.array([[0.05, 0.07, 0.0], [0.05, -0.07, 0.0],
                            [0.07, 0.065, 0.0]], np.float32),
    'front_sliding': np.array([[0.0, -0.07, 0.0], [0.0, 0.07, 0.0],
                               [0.01, 0.0, 0.04]], np.float32),
}


def update_curriculum_prob(prob, counts, nc: int, per: float):
    """The curriculum-probability staircase for a batch (JAX
    `multi_step.py:38-59`): ``prob`` and ``counts`` are (N, nc); ``per`` =
    num_goals_to_generate // num_curriculum. With a single curriculum (one
    block) the JAX function's indices 1 and -2 clamp to 0 (its write to 1 is
    dropped), and so do they here."""
    finished = counts >= per
    half = counts >= (per / 2)
    prob = torch.where(finished, 0.0, prob)
    cols = list(prob.unbind(1))
    # first curriculum
    first_split = half[:, 0] & ~finished[:, 0]
    cols[0] = torch.where(first_split, 0.5, cols[0])
    if nc < 2:
        cols[0] = torch.where(finished[:, 0], 1.0, cols[0])
        return torch.stack(cols, 1)
    cols[1] = torch.where(first_split, 0.5, cols[1])
    # middle curricula
    for i in range(1, nc - 1):
        cond = finished[:, i - 1] & ~finished[:, i]
        cols[i] = torch.where(cond & half[:, i], 0.5,
                              torch.where(cond, 1.0, cols[i]))
        cols[i + 1] = torch.where(cond & half[:, i], 0.5, cols[i + 1])
    # last curriculum
    cols[-1] = torch.where(finished[:, -2], 1.0, cols[-1])
    return torch.stack(cols, 1)


class KukaMultiBlockEnv(KukaEnvBase):
    """BlockStack / BlockRearrange / ChestPickAndPlace / ChestPush
    (`envs/task_envs/kuka_multi_step_envs.py`) with 1-5 blocks, for a batch
    of environments on ``device``."""

    def __init__(self, cfg: EnvConfig, device: torch.device):
        if cfg.family != 'multi_step':
            raise NotImplementedError('family %r comes with a later slice of '
                                      'the port' % cfg.family)
        super().__init__(cfg, device)
        self.nb = cfg.num_block
        self.nc = cfg.num_curriculum
        self.block_size = 0.03
        self.num_goals_per_curriculum = cfg.num_goals_to_generate // self.nc
        self.spec = S.multi_step_scene(cfg.num_block, cfg.has_chest,
                                       cfg.chest_door)
        self.scene = D.multibody_consts(self.spec,
                                        ik_workspace=self.ik_workspace,
                                        gripper=cfg.gripper)
        self.engine = CudaMultiBodyEngine(self.scene)
        if cfg.has_chest:
            # the chest shifts the blocks' spawn bounds (JAX
            # `multi_step.py:68-75`) and sets the goals' chest centre and
            # top (`:78-83`)
            self.object_lower = self.object_lower.copy()
            self.object_upper = self.object_upper.copy()
            self.object_lower[0] += 0.05
            self.object_upper[0] += 0.05
            self.object_lower[1] -= 0.05
            self.object_upper[1] += 0.05
            cb = np.asarray(self.spec.chest_base, np.float32)
            self.chest_center = np.array([cb[0] + 0.05, cb[1], 0.175],
                                         np.float32)
            self.chest_top = np.array([cb[0] + 0.05, cb[1], 0.3], np.float32)
            self.door_opened = cfg.chest_door_opened_state

    @property
    def goal_dim(self):
        cfg = self.cfg
        gd = 3 * cfg.num_block + (1 if cfg.has_chest else 0)
        if cfg.grip_informed_goal:
            gd += 4 if cfg.grasping else 3
        return gd

    # ------------------------------------------------------------------ reset
    def reset(self, n: int, gen: torch.Generator, curr=None):
        """n fresh episodes drawn from ``gen``: (EnvState, obs). ``curr``:
        the (curriculum_prob, goals_generated, curriculum_update) carried
        over from the previous episodes, which the reference keeps across
        resets."""
        block_pos = core.sample_block_positions(
            gen, n, self.nb, self.object_lower[:2], self.object_upper[:2],
            self.tip_initial[:2], 0.175)
        state = self._base_env_state(
            self._reset_phys(n, block_pos),
            torch.zeros((n, self.goal_dim), dtype=F32, device=self.device),
            nc=self.nc)
        if curr is not None:
            state = state._replace(curriculum_prob=curr[0],
                                   goals_generated=curr[1],
                                   curriculum_update=curr[2])
        state = self._generate_goal(state, block_pos, True, gen=gen)
        obs, state = self._get_obs(state)
        return state, obs

    # ------------------------------------------------------------------- step
    def step_finish(self, state: core.EnvState, gen=None):
        cfg = self.cfg
        obs, state = self._get_obs(state)
        reward, achieved = core.binary_or_dense_reward(
            obs['achieved_goal'], obs['desired_goal'],
            cfg.distance_threshold, cfg.binary_reward)
        return state, obs, reward, achieved

    def set_sub_goal(self, state: core.EnvState, sub_goal_ind):
        """Pin each env's desired goal to one of its decomposition sub-goals
        (index -1 wraps to the final goal; JAX `multi_step.py:175-181`)."""
        ind = torch.as_tensor(sub_goal_ind, dtype=torch.int32,
                              device=self.device).expand(
                                  state.sub_goal_ind.shape)
        wrapped = torch.where(ind < 0, ind + self.cfg.num_steps, ind).long()
        goal = state.sub_goals[torch.arange(len(ind), device=self.device),
                               wrapped]
        return state._replace(sub_goal_ind=ind, desired_goal=goal)

    # -------------------------------------------------------------------- obs
    def _get_obs(self, state: core.EnvState):
        """Field for field the JAX package's multi-step observation. Returns
        (obs, state): the goal is regenerated from the blocks' positions."""
        cfg = self.cfg
        ph = state.phys
        n = ph.q.shape[0]
        rs = R.robot_state(ph.q, ph.qd, ph.fq, ph.fqd, cfg.grasping,
                           gripper=cfg.gripper)
        gripper_xyz = rs['gripper_xyz']
        gvel = rs['gripper_vel_xyz']
        closeness = rs['gripper_finger_closeness']

        block_xyzs = ph.body_pos                            # (N, NB, 3)
        rel_xyz = gripper_xyz[:, None] - block_xyzs
        # per-block critic state: xyz, rel_xyz, quat (xyzw), rel_vel,
        # rel_vel_rpy (the reference's `block_rpy` is the base quaternion)
        block_states = torch.cat(
            [block_xyzs, rel_xyz, quatm.wxyz_to_xyzw(ph.body_quat),
             gvel[:, None] - ph.body_linvel,
             rs['gripper_vel_rpy'][:, None] - ph.body_angvel], -1).reshape(n, -1)
        state_vec = torch.cat([gripper_xyz, closeness, gvel,
                               rs['gripper_finger_vel'], block_states], -1)
        policy_state = torch.cat([gripper_xyz, closeness,
                                  rel_xyz.reshape(n, -1)], -1)
        if cfg.joint_control:
            state_vec = torch.cat([rs['joint_poses'], state_vec], -1)
            policy_state = torch.cat([rs['joint_poses'], policy_state], -1)
        achieved = [block_xyzs.reshape(n, -1)]
        if cfg.has_chest:
            # the door follows the blocks in the observation and the policy
            # state, and leads the achieved goal (JAX `multi_step.py:220-226`)
            door_q, door_qd = ph.door_q[:, None], ph.door_qd[:, None]
            kp_state = self._keypoint_state(ph.door_q, ph.door_qd)
            state_vec = torch.cat([state_vec, door_q, door_qd, kp_state], -1)
            policy_state = torch.cat([policy_state, door_q, kp_state], -1)
            achieved = [door_q] + achieved
            # hold the door open once the robot has opened it (`:227-230`)
            hold = torch.abs(self.door_opened - ph.door_q) <= 0.01
            state = state._replace(door_hold_open=state.door_hold_open | hold)
        if cfg.grip_informed_goal:
            achieved.append(gripper_xyz)
            if cfg.grasping:
                achieved.append(closeness)

        # regenerate the goal from the blocks' positions and re-pin an
        # active sub-goal
        state = self._generate_goal(state, block_xyzs, False,
                                    gripper_xyz=gripper_xyz,
                                    closeness=closeness)
        if cfg.task_decomposition:
            state = self.set_sub_goal(state, state.sub_goal_ind)
        obs = {'observation': torch.clamp(state_vec, -5.0, 5.0),
               'policy_state': torch.clamp(policy_state, -5.0, 5.0),
               'achieved_goal': torch.cat(achieved, -1),
               'desired_goal': state.desired_goal}
        return obs, state

    def _keypoint_state(self, door_q, door_qd):
        """The door's keypoints, each position and velocity (N, 18) (JAX
        `multi_step.py:255-268`, `chest.py:47-58`)."""
        kps = const(_KEYPOINTS[self.cfg.chest_door], door_q)
        dpos, drot = self.scene.door_frame(door_q)
        pts = dpos[:, None] + quatm.rotate(drot[:, None], kps[None])
        vel = self.scene.door_point_jac(pts, door_q) * door_qd[:, None, None]
        return torch.cat([pts, vel], -1).flatten(1)

    # ------------------------------------------------------------- curriculum
    def _draw_curriculum_level(self, state, gen):
        """level ~ Categorical(curriculum_prob), and the bookkeeping
        (JAX `multi_step.py:271-289`)."""
        level = torch.multinomial(state.curriculum_prob, 1,
                                  generator=gen)[:, 0]
        upd = state.curriculum_update.to(F32)[:, None]
        counts = state.goals_generated + torch.nn.functional.one_hot(
            level, self.nc).to(F32) * upd
        prob = torch.where(state.curriculum_update[:, None],
                           update_curriculum_prob(state.curriculum_prob, counts,
                                                  self.nc,
                                                  self.num_goals_per_curriculum),
                           state.curriculum_prob)
        return level, state._replace(
            curriculum_level=level.to(torch.int32), goals_generated=counts,
            curriculum_prob=prob,
            curriculum_goal_step=(level * 25 + 50).to(torch.int32))

    # ------------------------------------------------------------------ goals
    def _generate_goal(self, state, block_poses, new_target, gen=None,
                       gripper_xyz=None, closeness=None):
        """The desired goal from the blocks' poses (N, NB, 3); the chest
        tasks' reads the gripper's position and closeness, the rest pose's
        tip and 0 where none is given (at reset, as JAX `multi_step.py:
        292-309` does)."""
        task = self.cfg.task
        if task == 'block_stack':
            return self._goal_block_stack(state, block_poses, new_target, gen)
        if task == 'block_rearrange':
            return self._goal_block_rearrange(state, block_poses, new_target,
                                              gen)
        n = block_poses.shape[0]
        if gripper_xyz is None:
            gripper_xyz = self._tip_rest.expand(n, 3)
        if closeness is None:
            closeness = block_poses.new_zeros((n, 1))
        pick = task == 'chest_pick_and_place'
        return self._goal_chest(state, block_poses, new_target, gen,
                                gripper_xyz, closeness,
                                door_open=0.10 if pick else 0.12, pick=pick)

    @staticmethod
    def _by_order(order, rows):
        """(N, NB, 3) with row order[i] set to rows[:, i]."""
        return torch.zeros_like(rows).scatter(
            1, order.long()[..., None].expand(rows.shape), rows)

    # -- BlockStack ----------------------------------------------------------
    def _goal_block_stack(self, state, block_poses, new_target, gen):
        cfg, nb = self.cfg, self.nb
        n = block_poses.shape[0]
        dev = self.device
        if new_target:
            order = torch.argsort(torch.rand((n, nb), generator=gen,
                                             device=dev), 1).to(torch.int32)
            base_xy = core.rejection_uniform(
                gen, self.target_lower[:2], self.target_upper[:2],
                lambda xy: (torch.linalg.vector_norm(
                    xy[:, :, None] - block_poses[:, None, :, :2], dim=-1)
                    > 0.08).all(-1), n)
            heights = 0.175 + self.block_size * torch.arange(
                nb, dtype=F32, device=dev)
            target_xyzs = torch.cat([base_xy[:, None].expand(n, nb, 2),
                                     heights[None, :, None].expand(n, nb, 1)],
                                    -1)
            state = state._replace(block_order=order, target_xyzs=target_xyzs)
            if cfg.use_curriculum:
                _, state = self._draw_curriculum_level(state, gen)
        order, target_xyzs = state.block_order, state.target_xyzs
        rows = torch.arange(n, device=dev)
        width = torch.full((n, 1), 0.03, dtype=F32, device=dev)
        if cfg.use_curriculum:
            level = state.curriculum_level.long()
            # desired[order[i]] = target[i] if i <= level else pose[order[i]]
            take = torch.arange(nb, device=dev)[None] <= level[:, None]
            placed = block_poses[rows[:, None], order.long()]
            desired = self._by_order(order, torch.where(
                take[..., None], target_xyzs, placed))
            parts = [desired.reshape(n, -1)]
            if cfg.grip_informed_goal:
                parts += [target_xyzs[rows, level], width]
        else:
            desired = self._by_order(order, target_xyzs)
            parts = [desired.reshape(n, -1)]
            if cfg.grip_informed_goal:
                parts += [target_xyzs[:, -1], width]
            if cfg.task_decomposition:
                state = state._replace(sub_goals=self._stack_subgoals(
                    block_poses, target_xyzs, order))
        return state._replace(desired_goal=torch.cat(parts, -1))

    def _stack_subgoals(self, block_poses, target_xyzs, order):
        """`KukaBlockStackEnv._generate_subgoals` (JAX
        `multi_step.py:354-376`): (N, num_steps, goal_dim)."""
        nb = self.nb
        n = block_poses.shape[0]
        dev = self.device
        rows = torch.arange(n, device=dev)
        placed = block_poses[rows[:, None], order.long()]   # row i: order[i]
        width = torch.full((n, 1), 0.03, dtype=F32, device=dev)

        def blocks(j):
            """The poses with the first j ordered blocks at their targets."""
            take = torch.arange(nb, device=dev)[None, :, None] < j
            return self._by_order(order, torch.where(take, target_xyzs,
                                                     placed)).reshape(n, -1)
        subs = []
        for k in range(nb):
            if self.cfg.grip_informed_goal:
                subs.append(torch.cat([blocks(k), placed[:, k], width], -1))
                subs.append(torch.cat([blocks(k + 1), target_xyzs[:, k],
                                       width], -1))
            else:
                subs.append(blocks(k + 1))
        return torch.stack(subs, 1)

    # -- BlockRearrange ------------------------------------------------------
    def _goal_block_rearrange(self, state, block_poses, new_target, gen):
        cfg, nb = self.cfg, self.nb
        n = block_poses.shape[0]
        dev = self.device
        if new_target:
            # targets one after another, each > 0.06 m from the targets
            # before it and from every block
            xys = []
            for _ in range(nb):
                prev = torch.stack(xys, 1) if xys else None

                def valid(xy, prev=prev):
                    ok = (torch.linalg.vector_norm(
                        xy[:, :, None] - block_poses[:, None, :, :2], dim=-1)
                        > 0.06).all(-1)
                    if prev is not None:
                        ok = ok & (torch.linalg.vector_norm(
                            xy[:, :, None] - prev[:, None], dim=-1)
                            > 0.06).all(-1)
                    return ok
                xys.append(core.rejection_uniform(
                    gen, self.target_lower[:2], self.target_upper[:2], valid,
                    n))
            xy = torch.stack(xys, 1)
            target_xyzs = torch.cat([xy, xy.new_full((n, nb, 1), 0.175)], -1)
            state = state._replace(target_xyzs=target_xyzs)
            if cfg.use_curriculum:
                level, state = self._draw_curriculum_level(state, gen)
                # move a random subset of level + 1 blocks
                scores = torch.rand((n, nb), generator=gen, device=dev)
                ranks = torch.argsort(torch.argsort(scores, 1), 1)
                state = state._replace(
                    ind_block_to_move=ranks < (level[:, None] + 1))
        target_xyzs = state.target_xyzs
        if cfg.use_curriculum:
            mask = state.ind_block_to_move
            tidx = torch.clamp(torch.cumsum(mask.long(), 1) - 1, 0, nb - 1)
            rows = torch.arange(n, device=dev)[:, None]
            desired = torch.where(mask[..., None], target_xyzs[rows, tidx],
                                  block_poses)
        else:
            desired = target_xyzs
        return state._replace(desired_goal=desired.reshape(n, -1))

    # -- Chest tasks ---------------------------------------------------------
    def _goal_chest(self, state, block_poses, new_target, gen, gripper_xyz,
                    closeness, door_open, pick):
        """The door open to ``door_open`` and the blocks in the chest (JAX
        `multi_step.py:421-463`); under the curriculum a random ``level``
        blocks move (not ``level + 1`` as in block_rearrange)."""
        cfg, nb = self.cfg, self.nb
        n = block_poses.shape[0]
        dev = self.device
        center = const(self.chest_center, block_poses)
        top = const(self.chest_top, block_poses)
        if new_target and cfg.use_curriculum:
            level, state = self._draw_curriculum_level(state, gen)
            scores = torch.rand((n, nb), generator=gen, device=dev)
            ranks = torch.argsort(torch.argsort(scores, 1), 1)
            state = state._replace(ind_block_to_move=ranks < level[:, None])
        door = block_poses.new_full((n, 1), door_open)
        push_goal = center + const([0.03, 0.0, 0.0], center)
        if cfg.use_curriculum:
            blocks = torch.where(state.ind_block_to_move[..., None], center,
                                 block_poses)
            parts = [door, blocks.reshape(n, -1)]
            if cfg.grip_informed_goal:
                level0 = (state.curriculum_level == 0)[:, None]
                if pick:
                    parts += [torch.where(level0, gripper_xyz, top),
                              torch.where(level0, closeness, 0.06)]
                else:
                    parts += [torch.where(level0, gripper_xyz, push_goal)]
        else:
            parts = [door, center.expand(n, nb, 3).reshape(n, -1)]
            if cfg.grip_informed_goal:
                parts += ([top.expand(n, 3), door.new_full((n, 1), 0.06)]
                          if pick else [push_goal.expand(n, 3)])
            if cfg.task_decomposition:
                state = state._replace(sub_goals=self._chest_subgoals(
                    block_poses, gripper_xyz, closeness, door_open, pick))
        return state._replace(desired_goal=torch.cat(parts, -1))

    def _chest_subgoals(self, block_poses, gripper_xyz, closeness, door_open,
                        pick):
        """`_generate_subgoals` of the chest tasks (JAX `multi_step.py:
        465-518`): (N, num_steps, goal_dim). The first sub-goal (open the
        door, all else as it is) carries the gripper entries only with
        ``grip_informed_goal``, as the JAX package has it; the reference
        appends them always, which makes that sub-goal longer than the
        rest."""
        nb = self.nb
        n = block_poses.shape[0]
        center = const(self.chest_center, block_poses)
        top = const(self.chest_top, block_poses).expand(n, 3)
        door = block_poses.new_full((n, 1), door_open)
        ks = torch.arange(nb, device=self.device)

        def blocks_done(j, extra=None):
            take = ks < j
            if extra is not None:
                take = take | extra
            return torch.where(take[None, :, None], center,
                               block_poses).reshape(n, -1)
        first = [door, block_poses.reshape(n, -1)]
        if self.cfg.grip_informed_goal:
            first += [gripper_xyz, closeness] if pick else [gripper_xyz]
        subs = [torch.cat(first, -1)]
        width = door.new_full((n, 1), 0.03)
        shift = const([0.03, 0.0, 0.0], center)
        for k in range(nb):
            if not self.cfg.grip_informed_goal:
                subs.append(torch.cat([door, blocks_done(k + 1)], -1))
            elif pick:
                moved = blocks_done(k).reshape(n, nb, 3).clone()
                moved[:, k] = top
                subs += [torch.cat([door, blocks_done(k), block_poses[:, k],
                                    width], -1),
                         torch.cat([door, moved.reshape(n, -1), top, width],
                                   -1),
                         torch.cat([door, blocks_done(k, ks == k), top,
                                    door.new_full((n, 1), 0.06)], -1)]
            else:
                subs += [torch.cat([door, blocks_done(k),
                                    block_poses[:, k] + shift], -1),
                         torch.cat([door, blocks_done(k, ks == k),
                                    (center + shift).expand(n, 3)], -1)]
        return torch.stack(subs, 1)
