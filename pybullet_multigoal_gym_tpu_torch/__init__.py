"""pybullet_multigoal_gym_tpu_torch: the PyTorch and CUDA port of
`pybullet_multigoal_gym_tpu`, for NVIDIA Hopper (H100).

`make_env(task=...)` keeps the reference's keyword surface and returns a
single-env gym-style adapter (`GymStyleEnv`, numpy in and out);
`make_vec_env(num_envs=..., task=...)` returns the batched env on the card.
Its step runs hand-written CUDA kernels (`csrc/ik.cu`, and `csrc/engine.cu`
for the single-step family or `csrc/multibody.cu` for the multi-step and
push-primitive families), built with nvcc at first use; on the CPU
(``device='cpu'``) their plain PyTorch versions run instead. This package imports neither JAX nor the JAX
package.

Strict float32 everywhere: TF32 is off for matmuls and cuDNN, as the JAX
package forces 'highest' matmul precision (the engine's tiny 3x3 and 6x6
products lose too much in reduced precision).
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from pybullet_multigoal_gym_tpu_torch.config import EnvConfig, env_id  # noqa: E402
from pybullet_multigoal_gym_tpu_torch.envs.vec_env import (  # noqa: E402
    VecMGEnv, make_vec_env)
from pybullet_multigoal_gym_tpu_torch.adapter import GymStyleEnv  # noqa: E402

__version__ = '0.1.0'

# registry of env-id -> EnvConfig, mirroring the gym registration the
# reference performs (`__init__.py:85-176`)
registry = {}


def make_env(task='reach', gripper='parallel_jaw', num_block=5, render=False,
             binary_reward=True,
             grip_informed_goal=False, task_decomposition=False,
             joint_control=False, max_episode_steps=50, distance_threshold=0.05,
             primitive=None,
             image_observation=False, depth_image=False, goal_image=False,
             point_cloud=False, state_noise=False,
             visualize_target=True,
             camera_setup=None, observation_cam_id=None, goal_cam_id=0,
             use_curriculum=False, num_goals_to_generate=1e6,
             num_envs=None, seed=0, device=None):
    """Reference-compatible factory (`__init__.py:4-178`), as the JAX
    package's `make_env`.

    Returns a `GymStyleEnv` (one env, classic gym API, numpy in and out) by
    default; pass ``num_envs`` to get the batched `VecMGEnv` instead. Both
    run on ``device``: CUDA unless the caller passes ``device='cpu'``."""
    if observation_cam_id is None:
        observation_cam_id = [0]
    if task == 'slide':
        # slide task doesn't support image observation well (__init__.py:30-31)
        assert not image_observation, \
            "slide task doesn't support image observation well."
        image_observation = depth_image = goal_image = False
    if image_observation and camera_setup is not None:
        assert len(observation_cam_id) <= len(camera_setup) + 1, \
            'invalid observation camera id list'
        assert goal_cam_id <= len(camera_setup) - 1, 'invalid goal camera id'

    cfg = EnvConfig(
        task=task, gripper=gripper, num_block=num_block,
        binary_reward=binary_reward, grip_informed_goal=grip_informed_goal,
        task_decomposition=task_decomposition, joint_control=joint_control,
        max_episode_steps=max_episode_steps,
        distance_threshold=distance_threshold, primitive=primitive,
        image_observation=image_observation, depth_image=depth_image,
        goal_image=goal_image, point_cloud=point_cloud,
        state_noise=state_noise, visualize_target=visualize_target,
        observation_cam_id=tuple(observation_cam_id), goal_cam_id=goal_cam_id,
        use_curriculum=use_curriculum,
        num_goals_to_generate=int(num_goals_to_generate),
        camera_setup=EnvConfig.freeze_camera_setup(camera_setup),
    ).validate()

    eid = env_id(cfg, render=render)
    registry[eid] = cfg
    print('Task id: %s' % eid)
    if num_envs is not None:
        return VecMGEnv(cfg, num_envs=num_envs, device=device, seed=seed)
    return GymStyleEnv(cfg, seed=seed, device=device)
