"""The port's copies of the JAX package's numpy-only modules (model constants,
scene specs, lane culling, the env config) against the originals, and the
model constants written into the CUDA sources (`csrc/kin.cuh`) against the
model. All exact: the copies hold the same float64 values, and the CUDA
tables hold them rounded to float32 as the PyTorch path rounds them.
"""

import dataclasses
import importlib
import re
import types
from pathlib import Path

import numpy as np
import pytest

import pybullet_multigoal_gym_tpu  # noqa: F401  (JAX precision config)
from pybullet_multigoal_gym_tpu.config import EnvConfig as JaxConfig
from pybullet_multigoal_gym_tpu.config import env_id as jax_env_id
from pybullet_multigoal_gym_tpu.ops import lane_cull as JLC
from pybullet_multigoal_gym_tpu.ops import scene as JS
from pybullet_multigoal_gym_tpu_torch import EnvConfig, env_id
from pybullet_multigoal_gym_tpu_torch.model import kuka_model as KM
from pybullet_multigoal_gym_tpu_torch.ops import dynamics as D
from pybullet_multigoal_gym_tpu_torch.ops import fk
from pybullet_multigoal_gym_tpu_torch.ops import lane_cull as LC
from pybullet_multigoal_gym_tpu_torch.ops import scene as S

KIN_CUH = Path(fk.__file__).resolve().parent.parent / 'csrc' / 'kin.cuh'


def _assert_same(out, ref, where):
    if dataclasses.is_dataclass(ref):
        for f in dataclasses.fields(ref):
            _assert_same(getattr(out, f.name), getattr(ref, f.name),
                         '%s.%s' % (where, f.name))
    elif isinstance(ref, dict):
        assert sorted(out) == sorted(ref), where
        for k in ref:
            _assert_same(out[k], ref[k], '%s[%r]' % (where, k))
    elif isinstance(ref, (tuple, list)) and not np.isscalar(ref):
        assert len(out) == len(ref), where
        for i, (a, b) in enumerate(zip(out, ref)):
            _assert_same(a, b, '%s[%d]' % (where, i))
    else:
        np.testing.assert_array_equal(np.asarray(out), np.asarray(ref),
                                      err_msg=where)


@pytest.mark.parametrize('name', ['model.kuka_model', 'ops.scene',
                                  'ops.lane_cull', 'config'])
def test_module_values_match_jax(name):
    """Every module-level constant of the copy equals the original's."""
    out = importlib.import_module('pybullet_multigoal_gym_tpu_torch.' + name)
    ref = importlib.import_module('pybullet_multigoal_gym_tpu.' + name)
    values = {k: v for k, v in vars(ref).items()
              if not k.startswith('__') and not callable(v)
              and not isinstance(v, types.ModuleType)}
    assert values
    for k, v in values.items():
        _assert_same(getattr(out, k), v, '%s.%s' % (name, k))


@pytest.mark.parametrize('has_obj', [True, False])
@pytest.mark.parametrize('ik_workspace', [True, False])
def test_scene_and_lane_mask_match_jax(has_obj, ik_workspace):
    spec, jspec = S.single_step_scene(has_obj), JS.single_step_scene(has_obj)
    _assert_same(spec, jspec, 'spec')
    _assert_same(spec.np_arrays(), jspec.np_arrays(), 'np_arrays')
    _assert_same(LC.arm_lane_mask(spec, ik_workspace),
                 JLC.arm_lane_mask(jspec, ik_workspace), 'arm_lane_mask')


@pytest.mark.parametrize('keys', [('slot', 'cube'), ('rectangle',)])
@pytest.mark.parametrize('ik_workspace', [True, False])
def test_shape_assemble_scene_and_lane_mask_match_jax(keys, ik_workspace):
    """The push primitives' scenes: bodies of several geoms and sizes, and
    each sphere's reach per geom."""
    spec, jspec = S.shape_assemble_scene(keys), JS.shape_assemble_scene(keys)
    _assert_same(spec, jspec, 'spec')
    _assert_same(spec.np_arrays(), jspec.np_arrays(), 'np_arrays')
    _assert_same(LC.arm_lane_mask(spec, ik_workspace),
                 JLC.arm_lane_mask(jspec, ik_workspace), 'arm_lane_mask')


@pytest.mark.parametrize('kw', [
    dict(task='reach'), dict(task='push', binary_reward=False),
    dict(task='pick_and_place', joint_control=True),
    dict(task='push', gripper='robotiq85', max_episode_steps=100),
    dict(task='primitive_push_assemble', primitive='discrete_push'),
    dict(task='primitive_push_reach', primitive='continuous_push')])
def test_env_config_matches_jax(kw):
    cfg, jcfg = EnvConfig(**kw), JaxConfig(**kw)
    _assert_same(cfg, jcfg, 'EnvConfig')
    assert env_id(cfg) == jax_env_id(jcfg)


def _cuh_constants():
    """The ``KTABLE`` arrays and ``constexpr float`` scalars of kin.cuh."""
    src = KIN_CUH.read_text()
    number = r'-?\d+(?:\.\d*)?(?:e-?\d+)?'
    out = {}
    for m in re.finditer(r'KTABLE (?:float|int) (\w+)((?:\[\d+\])+) = '
                         r'(\{.*?\});', src, re.S):
        shape = tuple(int(d) for d in re.findall(r'\d+', m.group(2)))
        out[m.group(1)] = np.array(
            [float(x) for x in re.findall(number, m.group(3))]).reshape(shape)
    for m in re.finditer(r'constexpr float (\w+) = (%s)f;' % number, src):
        out[m.group(1)] = float(m.group(2))
    return out


def test_kernel_constants_match_model():
    model = {
        'OXYZ': KM.JOINT_ORIGIN_XYZ, 'OQ': fk.ORIGIN_QUAT_NP,
        'JL_LO': KM.JOINT_LIMIT_LOWER, 'JL_HI': KM.JOINT_LIMIT_UPPER,
        'IK_LO': KM.IK_LOWER, 'IK_HI': KM.IK_UPPER,
        'ARM_INERTIA': KM.ARM_EFFECTIVE_INERTIA,
        'SPH_LINK': KM.ARM_SPHERE_LINK, 'SPH_OFF': KM.ARM_SPHERE_OFFSET,
        'SPH_R': KM.ARM_SPHERE_RADIUS,
        'GRIPPER_BASE_OFFSET': KM.GRIPPER_BASE_OFFSET,
        'FINGER_ORIGIN': KM.FINGER_ORIGIN, 'FINGER_AXIS': KM.FINGER_AXIS,
        'FINGER_HALF': KM.FINGER_HALF_EXTENTS,
        'FINGER_LIMIT': KM.FINGER_LIMIT,
        'FINGER_MASS': KM.FINGER_MASS * KM.FINGER_INERTIA_SCALING,
        'FINGER_PD_FORCE': KM.FINGER_PD_FORCE,
        'ARM_PD_FORCE': KM.ARM_PD_FORCE, 'DT': D.DT_SUB,
        'GRAVITY': D.GRAVITY, 'ARM_SERVO_RATE': D.ARM_SERVO_RATE,
        'ARM_VEL_LIMIT': D.ARM_VEL_LIMIT,
        'FINGER_VEL_LIMIT': D.FINGER_VEL_LIMIT, 'BIAS_CAP': D.BIAS_CAP,
        'ROBOTIQ_PAD_HALF': KM.ROBOTIQ_PAD_HALF,
        'ROBOTIQ_INNER_X': KM.ROBOTIQ_INNER_X,
        'ROBOTIQ_INNER_Y': KM.ROBOTIQ_INNER_Y,
        'ROBOTIQ_ARM_TX': KM.ROBOTIQ_ARM_TX,
        'ROBOTIQ_ARM_TY': KM.ROBOTIQ_ARM_TY,
        'ROBOTIQ_TAB_X': KM.ROBOTIQ_TAB_X, 'ROBOTIQ_TAB_Y': KM.ROBOTIQ_TAB_Y,
        'ROBOTIQ_BASE_Z': KM.ROBOTIQ_BASE_OFFSET[2],
        'ROBOTIQ_JOINT_LIMIT': KM.ROBOTIQ_JOINT_LIMIT,
        'ROBOTIQ_FINGER_INERTIA': KM.ROBOTIQ_FINGER_INERTIA,
        'ROBOTIQ_PD_FORCE': KM.ROBOTIQ_PD_FORCE,
        'ROBOTIQ_VEL_LIMIT': KM.ROBOTIQ_VEL_LIMIT}
    cuh = _cuh_constants()
    assert sorted(cuh) == sorted(model)
    for k, v in model.items():
        np.testing.assert_array_equal(np.float32(cuh[k]), np.float32(v),
                                      err_msg=k)
