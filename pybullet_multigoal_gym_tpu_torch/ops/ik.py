"""Damped-least-squares inverse kinematics with a null-space rest-pose bias.

Counterpart of `pybullet_multigoal_gym_tpu/ops/ik.py:solve`, batched over a
leading env axis. This is the plain PyTorch version of kernel K1
(`ops/cuda_ik.py`, `csrc/ik.cu`): the CPU path and the tests run it, and the
chip smoke test holds the kernel against it. It also serves the rest-pose IK
at env construction.
"""

import numpy as np
import torch

from pybullet_multigoal_gym_tpu_torch.maths import quat as quatm
from pybullet_multigoal_gym_tpu_torch.model import kuka_model as KM
from pybullet_multigoal_gym_tpu_torch.ops import fk
from pybullet_multigoal_gym_tpu_torch.utils.tensors import const

DAMPING = 1e-3


def _chol_solve(A, b, n):
    """Solve A x = b for small SPD systems by an unrolled Cholesky
    factorisation (pivot clamped at 1e-12). A: (..., n, n), b: (..., n)."""
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp_min(s, 1e-12))
            else:
                L[i][j] = s / L[j][j]
    # forward substitution L y = b
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # back substitution L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def _orientation_error(r_cur, r_target):
    """Rotation vector taking r_cur to r_target (world frame)."""
    dq = quatm.mul(r_target, quatm.conj(r_cur))
    dq = dq * torch.sign(dq[..., :1])
    vnorm = torch.linalg.vector_norm(dq[..., 1:], dim=-1)
    angle = 2.0 * torch.atan2(vnorm, dq[..., 0])
    axis = dq[..., 1:] / vnorm[..., None].clamp_min(1e-12)
    return axis * angle[..., None]


def solve(target_pos, target_quat=None, rest_pose=None, q_init=None,
          num_iters=KM.IK_MAX_ITERS, gripper: str = 'parallel_jaw'):
    """Solve IK for the gripper tip.

    Args:
      target_pos: (..., 3) desired tip position.
      target_quat: (..., 4) desired tip orientation wxyz; defaults to the
        fixed downward orientation.
      rest_pose: (..., 7) null-space rest pose; defaults to KUKA_REST_POSE.
      q_init: (..., 7) starting configuration; defaults to rest_pose.
    Returns:
      (..., 7) joint angles, clamped to the joint limits.
    """
    batch = target_pos.shape[:-1]
    if target_quat is None:
        target_quat = const(KM.EE_FIXED_QUAT_WXYZ, target_pos).expand(
            batch + (4,))
    if rest_pose is None:
        rest_pose = const(KM.KUKA_REST_POSE, target_pos).expand(batch + (7,))
    q = rest_pose if q_init is None else q_init
    lower, upper = const(KM.IK_LOWER, q), const(KM.IK_UPPER, q)
    eye = const(DAMPING * np.eye(6), q)
    for i in range(num_iters):
        pos, rots = fk.link_frames(q)
        tip = fk._tip(pos, rots, gripper)
        J = fk._jacobian(pos, rots, tip)                    # (..., 6, 7)
        err = torch.cat([target_pos - tip,
                         _orientation_error(rots[..., 6, :], target_quat)], -1)
        # damped least squares: dq = J^T (J J^T + lambda I)^-1 err
        A = (J[..., :, None, :] * J[..., None, :, :]).sum(-1) + eye
        y = _chol_solve(A, err, 6)
        dq = (J * y[..., :, None]).sum(-2)
        # null-space pull toward the rest pose, over the first half of the
        # iterations only: (I - J^T A^-1 J) e via a second Cholesky solve
        e = rest_pose - q
        u = _chol_solve(A, (J * e[..., None, :]).sum(-1), 6)
        ns = e - (J * u[..., :, None]).sum(-2)
        ns_w = 0.5 if i < num_iters // 2 else 0.0
        q = torch.clamp(q + dq + ns_w * ns, lower, upper)
    return torch.clamp(q, const(KM.JOINT_LIMIT_LOWER, q),
                       const(KM.JOINT_LIMIT_UPPER, q))
