"""The port's quaternion maths, FK and IK (kernel K1's plain version) against
the JAX package, on the same numpy-seeded inputs.

Tolerances: 1e-6 for quaternion maths and FK (the same float32 operations in
the same order; libm sin/cos/atan2 may differ by an ulp), 1e-5 rad for IK
(8 or 40 damped iterations amplify those ulps), tip residual 1e-3 m after 40
iterations (tests/test_pallas_engine.py). K1 against its plain version on the
card: tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pybullet_multigoal_gym_tpu  # noqa: F401  (JAX precision config)
from pybullet_multigoal_gym_tpu.maths import quat as jq
from pybullet_multigoal_gym_tpu.ops import fk as jfk
from pybullet_multigoal_gym_tpu.ops import ik as jik
from pybullet_multigoal_gym_tpu_torch.maths import quat as tq
from pybullet_multigoal_gym_tpu_torch.model import kuka_model as KM
from pybullet_multigoal_gym_tpu_torch.ops import fk as tfk
from pybullet_multigoal_gym_tpu_torch.ops import ik as tik
from pybullet_multigoal_gym_tpu_torch.ops.cuda_ik import CudaIK
from tests.torch_common import n, t, workspace_targets

torch.set_num_threads(1)

RNG = np.random.default_rng(0)
Q = RNG.normal(size=(64, 4)).astype(np.float32)
Q /= np.linalg.norm(Q, axis=-1, keepdims=True)
Q2 = RNG.normal(size=(64, 4)).astype(np.float32)
V = RNG.normal(size=(64, 3)).astype(np.float32)
ANG = RNG.uniform(-3.0, 3.0, (64, 3)).astype(np.float32)
JQ = RNG.uniform(KM.JOINT_LIMIT_LOWER, KM.JOINT_LIMIT_UPPER,
                 (64, 7)).astype(np.float32)
FQ = RNG.uniform(-KM.FINGER_LIMIT, KM.FINGER_LIMIT, (64, 2)).astype(np.float32)


def _quat_from_rpy(rpy):
    r, p, y = (rpy[:, k] * 0.5 for k in range(3))
    cr, sr, cp, sp, cy, sy = (np.cos(r), np.sin(r), np.cos(p), np.sin(p),
                              np.cos(y), np.sin(y))
    return np.stack([cr * cp * cy + sr * sp * sy, sr * cp * cy - cr * sp * sy,
                     cr * sp * cy + sr * cp * sy, cr * cp * sy - sr * sp * cy],
                    -1).astype(np.float32)


# away from gimbal lock (|pitch| < 1.2 rad): near pitch = +-pi/2, asin and
# atan2 amplify one-ulp input differences past 1e-6
Q_EUL = _quat_from_rpy(RNG.uniform([-3.0, -1.2, -3.0], [3.0, 1.2, 3.0],
                                   (64, 3)))

QUAT_CASES = {
    'mul': (lambda m: m.mul, (Q, Q2)),
    'conj': (lambda m: m.conj, (Q,)),
    'normalize': (lambda m: m.normalize, (Q2,)),
    'rotate': (lambda m: m.rotate, (Q, V)),
    'rotate_inv': (lambda m: m.rotate_inv, (Q, V)),
    'from_axis_angle': (lambda m: m.from_axis_angle, (V, ANG[:, 0])),
    'to_matrix': (lambda m: m.to_matrix, (Q,)),
    'from_matrix': (lambda m: lambda q: m.from_matrix(m.to_matrix(q)), (Q,)),
    'euler_xyz_to_quat': (lambda m: m.euler_xyz_to_quat, (ANG,)),
    'quat_to_euler_xyz': (lambda m: m.quat_to_euler_xyz, (Q_EUL,)),
    'euler_zyz_to_quat': (lambda m: m.euler_zyz_to_quat, (ANG,)),
    'quat_to_euler_zyz': (lambda m: m.quat_to_euler_zyz, (Q,)),
    'yaw_quat_zyz': (lambda m: m.yaw_quat_zyz, (ANG[:, 0],)),
    'xyzw_roundtrip': (lambda m: lambda q: m.xyzw_to_wxyz(m.wxyz_to_xyzw(q)),
                       (Q,)),
    'integrate_angvel': (lambda m: lambda q, w: m.integrate_angvel(q, w, 0.002),
                         (Q, V)),
}


@pytest.mark.parametrize('name', sorted(QUAT_CASES))
def test_quat_matches_jax(name):
    get, args = QUAT_CASES[name]
    ref = n(get(jq)(*[jnp.asarray(a) for a in args]))
    out = n(get(tq)(*[t(a) for a in args]))
    np.testing.assert_allclose(out, ref, atol=1e-6, err_msg=name)


def test_link_frames_and_tip_pose_match_jax():
    jp, jr = jfk.link_frames(jnp.asarray(JQ))
    tp, tr = tfk.link_frames(t(JQ))
    np.testing.assert_allclose(n(tp), n(jp), atol=1e-6)
    np.testing.assert_allclose(n(tr), n(jr), atol=1e-6)
    jtip, jrot = jfk.tip_pose(jnp.asarray(JQ))
    ttip, trot = tfk.tip_pose(t(JQ))
    np.testing.assert_allclose(n(ttip), n(jtip), atol=1e-6)
    np.testing.assert_allclose(n(trot), n(jrot), atol=1e-6)
    np.testing.assert_allclose(n(tfk.tip_jacobian(t(JQ))),
                               n(jfk.tip_jacobian(jnp.asarray(JQ))), atol=1e-6)


def test_ee_frames_match_jax():
    ref = jfk.ee_frames(jnp.asarray(JQ), jnp.asarray(FQ))
    out = tfk.ee_frames(t(JQ), t(FQ))
    assert sorted(ref) == sorted(out)
    for k in ref:
        np.testing.assert_allclose(n(out[k]), n(ref[k]), atol=1e-6, err_msg=k)


@pytest.fixture(scope='module')
def ik_inputs():
    rng = np.random.default_rng(1)
    tgt = workspace_targets(rng, 16)
    # warm start as in the env step: a configuration near the rest pose
    q0 = (np.asarray(KM.KUKA_REST_POSE, np.float32)
          + rng.uniform(-0.2, 0.2, (16, 7)).astype(np.float32))
    return tgt, q0


@pytest.mark.parametrize('iters', [8, 40])
def test_ik_plain_matches_jax(ik_inputs, iters):
    tgt, q0 = ik_inputs
    ref = jax.jit(lambda a, b: jik.solve(a, q_init=b, num_iters=iters))(
        jnp.asarray(tgt), jnp.asarray(q0))
    out = tik.solve(t(tgt), q_init=t(q0), num_iters=iters)
    np.testing.assert_allclose(n(out), n(ref), atol=1e-5)
    if iters == 40:
        tip, _ = tfk.tip_pose(out)
        assert np.linalg.norm(n(tip) - tgt, axis=-1).max() < 1e-3


def test_ik_wrapper_runs_plain_on_cpu(ik_inputs):
    tgt, q0 = ik_inputs
    w = CudaIK(num_iters=8)
    out = w.solve(t(tgt), q_init=t(q0))
    np.testing.assert_array_equal(n(out),
                                  n(tik.solve(t(tgt), q_init=t(q0),
                                              num_iters=8)))
    assert w.launches == 0


def test_ik_wrapper_refuses_other_devices():
    """A tensor that is not on the CPU never reaches the plain version."""
    w = CudaIK(num_iters=8)
    with pytest.raises(ValueError):
        w.solve(torch.empty((4, 3), device='meta'))
    # the raw launch takes CUDA memory only
    with pytest.raises(ValueError, match='CUDA memory'):
        w.launch(torch.zeros((21, 4)), torch.zeros((7, 4)))
    assert w.launches == 0
