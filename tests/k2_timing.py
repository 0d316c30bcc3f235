"""Time kernel K2 on the card on the push, reach and slide main paths' own
inputs (step 26 of a seeded drive at 4096 envs, as `chip_smoke.py`
captures them), with the package (and `chip_smoke.py`) found first on the
path, and print one JSON line per scene: the kernel's mean time over
back-to-back launches of 100 substeps and a hash of its outputs (a package
without slide prints that it has none).

    python tests/k2_timing.py                          # this checkout
    PYTHONPATH=<other checkout> python tests/k2_timing.py

Two checkouts compared in one call, in turns (A, B, B, A), show whether a
change moved K2's time or its outputs on scenes it should leave alone.
Imports nothing of JAX; exits non-zero without a CUDA device.
"""

import hashlib
import json
import sys


def main():
    import torch
    if not torch.cuda.is_available():
        print('k2_timing: no CUDA device', file=sys.stderr)
        return 1
    import chip_smoke as C
    import pybullet_multigoal_gym_tpu_torch as port
    from pybullet_multigoal_gym_tpu_torch.ops.cuda_engine import (CudaEngine,
                                                                  pack)
    for task in ('push', 'reach', 'slide'):
        try:
            c = C.main_path_inputs(torch, port, task, at=(25,))[0]
        except NotImplementedError as e:
            print(json.dumps(dict(phase='k2_timing', task=task,
                                  skipped=str(e), package=port.__file__)),
                  flush=True)
            continue
        w = CudaEngine(c['scene'])
        rows, ctl = pack(c['phys'], c['controls'])
        out = torch.empty_like(rows)
        ms = C.time_ms(lambda: w.launch(rows, ctl, out, 100), 10)
        print(json.dumps(dict(
            phase='k2_timing', task=task, envs=rows.shape[1], substeps=100,
            ms=ms, outputs_sha256=hashlib.sha256(
                out.cpu().numpy().tobytes()).hexdigest(),
            package=port.__file__, card=C.card_line())), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
