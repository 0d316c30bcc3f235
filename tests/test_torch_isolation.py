"""The port stands alone: importing it and stepping an env of each family
(reach, and block_rearrange and chest_push on the multi-body engine),
resetting a push-primitive env and an insertion env, and resetting and
stepping slide through `make_env`'s single-env adapter, loads neither JAX
nor any module of the JAX package,
and its entry point asks for CUDA unless the caller passes
``device='cpu'``."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pybullet_multigoal_gym_tpu_torch import make_vec_env

ROOT = Path(__file__).resolve().parent.parent

_PROBE = r'''
import json, sys, torch
torch.set_num_threads(1)
import pybullet_multigoal_gym_tpu_torch as port
from pybullet_multigoal_gym_tpu_torch import interop
from pybullet_multigoal_gym_tpu_torch.utils import demonstrator
env = port.make_vec_env(num_envs=2, task='reach', device='cpu')
state, obs = env.reset()
state, obs, reward, done, info = env.step(
    state, torch.zeros((2, env.cfg.action_dim)))
interop.state_to_numpy(state)
multi = port.make_vec_env(num_envs=2, task='block_rearrange', num_block=1,
                          device='cpu')
mstate, mobs = multi.reset()
mstate, mobs, _, _, _ = multi.step(mstate, torch.zeros((2, 3)))
interop.state_to_numpy(mstate)
chest = port.make_vec_env(num_envs=2, task='chest_push', num_block=1,
                          device='cpu')
cstate, cobs = chest.reset()
cstate, cobs, _, _, _ = chest.step(cstate, torch.zeros((2, 3)))
interop.state_to_numpy(cstate)
prim = port.make_vec_env(num_envs=2, task='primitive_push_assemble',
                         primitive='discrete_push', device='cpu')
pstate, pobs = prim.reset()
prim.core.step_decode_waypoints(torch.zeros((2, 3)))
interop.state_to_numpy(pstate)
ins = port.make_vec_env(num_envs=2, task='insertion', device='cpu')
istate, iobs = ins.reset()
ins.core.step_decode_pre(istate, torch.zeros((2, 7)))
interop.state_to_numpy(istate)
demonstrator.StepDemonstrator(demonstrator.default_demonstrations(2))
gym = port.make_env(task='slide', device='cpu')
gobs = gym.reset()
gobs, _, _, _ = gym.step(gym.action_space.sample())
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith('jax.')
             or m == 'pybullet_multigoal_gym_tpu'
             or m.startswith('pybullet_multigoal_gym_tpu.'))
print(json.dumps({'bad': bad, 'obs': list(obs['observation'].shape),
                  'multi_obs': list(mobs['observation'].shape),
                  'chest_obs': list(cobs['observation'].shape),
                  'prim_obs': list(pobs['observation'].shape),
                  'ins_obs': list(iobs['observation'].shape),
                  'slide_obs': list(gobs['observation'].shape)}))
'''


def _imported_modules(path):
    """Every module name an ``import`` statement in ``path`` names."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize('source', ['pybullet_multigoal_gym_tpu_torch',
                                    'chip_smoke.py', 'tests/torch_common.py',
                                    'tests/test_torch_kernels.py',
                                    'tests/kernel_ops.py',
                                    'tests/k2_timing.py',
                                    'tests/policies.py'])
def test_sources_name_no_jax(source):
    """No import statement anywhere in the port, the chip smoke test or the
    card tests and their helpers names JAX or the JAX package, including
    imports inside functions that the subprocess probe below does not
    reach."""
    root = ROOT / source
    files = sorted(root.rglob('*.py')) if root.is_dir() else [root]
    assert files
    for path in files:
        for name in _imported_modules(path):
            top = name.split('.')[0]
            assert top not in ('jax', 'jaxlib', 'pybullet_multigoal_gym_tpu'), \
                (path, name)


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, '-c', _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {'bad': [], 'obs': [2, 3], 'multi_obs': [2, 24],
                   'chest_obs': [2, 44], 'prim_obs': [2, 12],
                   'ins_obs': [2, 24], 'slide_obs': [20]}


def test_default_device_is_cuda():
    """No quiet fallback: without CUDA the default device raises."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        make_vec_env(num_envs=4096, task='push')
