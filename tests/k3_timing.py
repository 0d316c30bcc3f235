"""Time kernel K3 on the card on the block, primitive and chest_push (4
blocks) main paths' own inputs, with the package (and `chip_smoke.py`)
found first on the path, and print one JSON line per scene: the kernel's
mean time over back-to-back launches and a hash of its outputs (a package
without the chest prints that it has none).

    python tests/k3_timing.py                          # this checkout
    PYTHONPATH=<other checkout> python tests/k3_timing.py

Two checkouts compared in one call, in turns (A, B, B, A), show whether a
change moved K3's time or its outputs on scenes it should leave alone.
Imports nothing of JAX; exits non-zero without a CUDA device.
"""

import hashlib
import json
import sys


def main():
    import torch
    if not torch.cuda.is_available():
        print('k3_timing: no CUDA device', file=sys.stderr)
        return 1
    import chip_smoke as C
    import pybullet_multigoal_gym_tpu_torch as port
    from pybullet_multigoal_gym_tpu_torch.ops.cuda_multibody import (
        CudaMultiBodyEngine, pack)
    # each scene timed right after its capture, before any launch of a later
    # scene: the runtime keeps per-thread local memory for the largest stack
    # launched so far, and a larger reservation moves other kernels' times
    # (the primitive's K3 by up to 6 % after a chest_push launch, on an H100)
    cases = [
        ('block_rearrange', lambda: C.main_path_inputs(
            torch, port, 'block_rearrange', at=(25,), num_block=2)[0], 100),
        ('block_stack', lambda: C.main_path_inputs(
            torch, port, 'block_stack', at=(25,), num_envs=C.STACK_ENVS,
            num_block=5)[0], 100),
        ('primitive_push_assemble',
         lambda: C.primitive_main_inputs(torch, port)[-1], C.PRIM_SUBSTEPS),
        ('chest_push', lambda: C.main_path_inputs(
            torch, port, 'chest_push', at=(25,), num_envs=1024,
            num_block=4)[0], 100)]
    for task, capture, n_sub in cases:
        try:
            c = capture()
        except NotImplementedError as e:
            print(json.dumps(dict(phase='k3_timing', task=task,
                                  skipped=str(e), package=port.__file__)),
                  flush=True)
            continue
        w = CudaMultiBodyEngine(c['scene'])
        rows, ctl = pack(c['phys'], c['controls'])
        out = torch.empty_like(rows)
        ms = C.time_ms(lambda: w.launch(rows, ctl, out, n_sub), 10)
        print(json.dumps(dict(
            phase='k3_timing', task=task, envs=rows.shape[1], substeps=n_sub,
            ms=ms, outputs_sha256=hashlib.sha256(
                out.cpu().numpy().tobytes()).hexdigest(),
            package=port.__file__, card=C.card_line())), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
