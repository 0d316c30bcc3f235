"""Multi-block long-horizon family: BlockStack and BlockRearrange, batched.

Counterpart of `pybullet_multigoal_gym_tpu/envs/multi_step.py` with the same
observation and goal layouts, curriculum bookkeeping and task-decomposition
sub-goals. Every method works on a whole batch (leading env axis) on the
env's device; random draws come from the env's `torch.Generator`. The step
is split as in the single-step family: ``step_decode_pre``, then the vec
wrapper runs IK (kernel K1) and the control step (kernel K3,
`ops/cuda_multibody.py`), then ``step_finish``, which also regenerates the
goal from the blocks' positions.

The chest tasks (the door and the chest walls of K3) come with a later
slice of the port.
"""

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
    """BlockStack / BlockRearrange (`envs/task_envs/kuka_multi_step_envs.py`)
    with 1-5 blocks, for a batch of environments on ``device``."""

    def __init__(self, cfg: EnvConfig, device: torch.device):
        if cfg.family != 'multi_step':
            raise NotImplementedError('family %r comes with a later slice of '
                                      'the port' % cfg.family)
        if cfg.has_chest:
            raise NotImplementedError('the chest tasks (the door and the '
                                      'chest walls of the multi-body kernel) '
                                      'come with a later slice of the port')
        super().__init__(cfg, device)
        self.nb = cfg.num_block
        self.nc = cfg.num_curriculum
        self.block_size = 0.03
        self.num_goals_per_curriculum = cfg.num_goals_to_generate // self.nc
        self.spec = S.multi_step_scene(cfg.num_block)
        self.scene = D.multibody_consts(self.spec,
                                        ik_workspace=self.ik_workspace)
        self.engine = CudaMultiBodyEngine(self.scene)

    @property
    def goal_dim(self):
        cfg = self.cfg
        gd = 3 * cfg.num_block
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
        rs = R.robot_state(ph.q, ph.qd, ph.fq, ph.fqd, cfg.grasping)
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
        if cfg.grip_informed_goal:
            achieved.append(gripper_xyz)
            if cfg.grasping:
                achieved.append(closeness)

        # regenerate the goal from the blocks' positions and re-pin an
        # active sub-goal
        state = self._generate_goal(state, block_xyzs, False)
        if cfg.task_decomposition:
            state = self.set_sub_goal(state, state.sub_goal_ind)
        obs = {'observation': torch.clamp(state_vec, -5.0, 5.0),
               'policy_state': torch.clamp(policy_state, -5.0, 5.0),
               'achieved_goal': torch.cat(achieved, -1),
               'desired_goal': state.desired_goal}
        return obs, state

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
    def _generate_goal(self, state, block_poses, new_target, gen=None):
        if self.cfg.task == 'block_stack':
            return self._goal_block_stack(state, block_poses, new_target, gen)
        return self._goal_block_rearrange(state, block_poses, new_target, gen)

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
