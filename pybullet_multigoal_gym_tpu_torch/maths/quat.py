"""Quaternion and rotation math, batched over leading axes (torch).

Counterpart of `pybullet_multigoal_gym_tpu/maths/quat.py`, with the same
conventions:

* Quaternions are stored **wxyz** (scalar first). PyBullet's xyzw layout
  appears only at API boundaries (:func:`wxyz_to_xyzw` / :func:`xyzw_to_wxyz`).
* Two Euler conventions coexist in the reference and both are provided:
  - :func:`euler_zyz_to_quat` / :func:`quat_to_euler_zyz` — the
    `numpy-quaternion` spherical (Z-Y-Z) convention, used for EE rotation
    control and object yaw goals;
  - :func:`euler_xyz_to_quat` / :func:`quat_to_euler_xyz` — PyBullet's
    roll-pitch-yaw extrinsic X-Y-Z convention, used for gripper orientation
    observations.
"""

import torch

_EPS = 1e-12


def cross(a, b):
    """Cross product over the last axis, written out (same operation order
    as `jnp.cross`)."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1,
                        a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _norm(v):
    return torch.sqrt((v * v).sum(-1, keepdim=True))


def normalize(q):
    return q / _norm(q).clamp_min(_EPS)


def mul(q1, q2):
    """Hamilton product, wxyz."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def rotate(q, v):
    """Rotate vector(s) v by quaternion(s) q (wxyz)."""
    w = q[..., :1]
    u = q[..., 1:]
    u, v = torch.broadcast_tensors(u, v)
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def rotate_inv(q, v):
    return rotate(conj(q), v)


def from_axis_angle(axis, angle):
    axis = axis / _norm(axis).clamp_min(_EPS)
    half = angle[..., None] * 0.5
    return torch.cat([torch.cos(half), axis * torch.sin(half)], dim=-1)


def to_matrix(q):
    """3x3 rotation matrix (rows) from a wxyz quaternion: (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(r.shape[:-1] + (3, 3))


def from_matrix(m):
    """wxyz quaternion from a 3x3 rotation matrix (Shepperd's method,
    branchless: the best-conditioned of four candidates)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    one = torch.ones_like(tr)
    cand = torch.stack([
        torch.stack([one + tr, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, one + m00 - m11 - m22, m01 + m10, m02 + m20], -1),
        torch.stack([m02 - m20, m01 + m10, one - m00 + m11 - m22, m12 + m21], -1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, one - m00 - m11 + m22], -1),
    ], -2)
    idx = torch.stack([tr, m00, m11, m22], -1).argmax(-1)
    q = torch.take_along_dim(cand, idx[..., None, None], dim=-2).squeeze(-2)
    return normalize(q) * torch.sign(q[..., :1] + _EPS)


def euler_xyz_to_quat(rpy):
    """PyBullet ``getQuaternionFromEuler``: extrinsic X-Y-Z (roll, pitch, yaw)."""
    r, p, y = rpy[..., 0] * 0.5, rpy[..., 1] * 0.5, rpy[..., 2] * 0.5
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return torch.stack([
        cr * cp * cy + sr * sp * sy,
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
    ], dim=-1)


def quat_to_euler_xyz(q):
    """Inverse of :func:`euler_xyz_to_quat` (PyBullet ``getEulerFromQuaternion``)."""
    w, x, y, z = normalize(q).unbind(-1)
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


def euler_zyz_to_quat(abc):
    """`numpy-quaternion` ``from_euler_angles(alpha, beta, gamma)``:
    q = exp(alpha/2 * z) * exp(beta/2 * y) * exp(gamma/2 * z)."""
    a, b, g = abc[..., 0] * 0.5, abc[..., 1] * 0.5, abc[..., 2] * 0.5
    ca, sa = torch.cos(a), torch.sin(a)
    cb, sb = torch.cos(b), torch.sin(b)
    cg, sg = torch.cos(g), torch.sin(g)
    return torch.stack([
        ca * cb * cg - sa * cb * sg,
        ca * sb * sg - sa * sb * cg,
        ca * sb * cg + sa * sb * sg,
        sa * cb * cg + ca * cb * sg,
    ], dim=-1)


def quat_to_euler_zyz(q):
    """`numpy-quaternion` ``as_euler_angles``: inverse Z-Y-Z decomposition."""
    w, x, y, z = normalize(q).unbind(-1)
    alpha = torch.atan2(z, w) + torch.atan2(-x, y)
    beta = 2 * torch.atan2(torch.sqrt(x * x + y * y), torch.sqrt(w * w + z * z))
    gamma = torch.atan2(z, w) - torch.atan2(-x, y)
    return torch.stack([alpha, beta, gamma], dim=-1)


def yaw_quat_zyz(yaw):
    """Quaternion of a pure z-rotation by ``yaw``, built as the reference's
    object-yaw randomisation does (ZYZ angles (0, 0, yaw))."""
    zeros = torch.zeros_like(yaw)
    return euler_zyz_to_quat(torch.stack([zeros, zeros, yaw], dim=-1))


def wxyz_to_xyzw(q):
    return torch.cat([q[..., 1:], q[..., :1]], dim=-1)


def xyzw_to_wxyz(q):
    return torch.cat([q[..., 3:], q[..., :3]], dim=-1)


def integrate_angvel(q, omega, dt):
    """Integrate a world-frame angular velocity over dt (first order exp map)."""
    angle = _norm(omega)[..., 0]
    axis = omega / angle[..., None].clamp_min(_EPS)
    return normalize(mul(from_axis_angle(axis, angle * dt), q))
