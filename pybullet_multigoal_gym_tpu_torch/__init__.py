"""pybullet_multigoal_gym_tpu_torch: the PyTorch and CUDA port of
`pybullet_multigoal_gym_tpu`, for NVIDIA Hopper (H100).

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

__version__ = '0.1.0'
