"""Kernel K1: batched damped-least-squares IK on the card (`csrc/ik.cu`).

Replaces `pybullet_multigoal_gym_tpu/ops/pallas_ik.py:_build_ik_kernel`
(launched through `PallasIK.solve`). Its plain version is `ops/ik.py:solve`:
the wrapper runs that for tensors on the CPU and launches the kernel for
tensors on a CUDA device, and raises for any other device.

The kernel maps one thread to one environment and keeps every iteration in
registers. It reads a (21, N) SoA block (target position 3, target quaternion
4, rest pose 7, start configuration 7) so that neighbouring threads read
neighbouring addresses, and writes q as (7, N). Bound: operations (about 1.4
thousand per environment and iteration against 112 bytes of traffic).
"""

import numpy as np
import torch

from pybullet_multigoal_gym_tpu_torch.model import kuka_model as KM
from pybullet_multigoal_gym_tpu_torch.ops import _build, ik
from pybullet_multigoal_gym_tpu_torch.utils.tensors import const


def check_operand(x, name, n, k, device):
    """Raise unless ``x`` is a float32 (n, k) tensor on ``device``."""
    if x.device != device:
        raise ValueError('%s is on %s, expected %s' % (name, x.device, device))
    if x.dtype != torch.float32:
        raise TypeError('%s must be float32, got %s' % (name, x.dtype))
    if tuple(x.shape) != (n, k):
        raise ValueError('%s must have shape %s, got %s'
                         % (name, (n, k), tuple(x.shape)))


def check_rows(x, name, k, n, device):
    """Raise unless ``x`` is a contiguous float32 (k, n) tensor on the CUDA
    ``device``: the SoA rows a kernel reads or writes."""
    if device.type != 'cuda':
        raise ValueError('%s is on %s: the kernel reads CUDA memory only'
                         % (name, device))
    check_operand(x, name, k, n, device)
    if not x.is_contiguous():
        raise ValueError('%s must be contiguous' % name)


def pack(target_pos, target_quat=None, rest_pose=None, q_init=None):
    """The kernel's (21, N) input rows, with `ik.solve`'s defaults for the
    optional inputs. Raises unless each is a float32 (N, k) tensor on the
    device of ``target_pos``."""
    n = target_pos.shape[0]
    if target_quat is None:
        target_quat = const(KM.EE_FIXED_QUAT_WXYZ, target_pos).expand(n, 4)
    if rest_pose is None:
        rest_pose = const(KM.KUKA_REST_POSE, target_pos).expand(n, 7)
    if q_init is None:
        q_init = rest_pose
    args = (target_pos, target_quat, rest_pose, q_init)
    for x, name, k in zip(args, ('target_pos', 'target_quat', 'rest_pose',
                                 'q_init'), (3, 4, 7, 7)):
        check_operand(x, name, n, k, target_pos.device)
    return torch.cat(args, 1).t().contiguous()


class CudaIK:
    """Batched IK front-end; inputs carry a leading env axis (N, ...).

    ``launches`` counts the kernel's launches (CPU calls are not counted)."""

    def __init__(self, num_iters: int = KM.IK_MAX_ITERS,
                 gripper: str = 'parallel_jaw'):
        self.num_iters = int(num_iters)
        self.gripper = gripper
        # the gripper's tip in link 7's frame (`pallas_ik.py:95`)
        self.tip_offset = [float(x) for x in
                           np.float32(KM.tip_offset_for(gripper))]
        self.launches = 0

    def solve(self, target_pos, target_quat=None, rest_pose=None,
              q_init=None):
        """(N, 7) joint angles for tip targets ``target_pos`` (N, 3)."""
        device = target_pos.device
        if device.type == 'cpu':
            return ik.solve(target_pos, target_quat, rest_pose, q_init,
                            num_iters=self.num_iters, gripper=self.gripper)
        if device.type != 'cuda':
            raise ValueError('CudaIK runs on cuda (kernel) or cpu (plain '
                             'version), not %s' % device)
        packed = pack(target_pos, target_quat, rest_pose, q_init)
        out = torch.empty((7, packed.shape[1]), dtype=torch.float32,
                          device=device)
        self.launch(packed, out)
        return out.t()

    def launch(self, packed, out):
        """One launch on the current stream: `pack`'s (21, N) rows in, the
        (7, N) joint angles into ``out``."""
        n, device = packed.shape[-1], packed.device
        check_rows(packed, 'packed', 21, n, device)
        check_rows(out, 'out', 7, n, device)
        kern = _build.load('ik')
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            rc = kern.fn(packed.data_ptr(), out.data_ptr(), n, self.num_iters,
                         *self.tip_offset, stream)
        _build.check(rc, 'ik')
        self.launches += 1
