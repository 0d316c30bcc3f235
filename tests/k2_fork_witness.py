"""Where a slide stress state forks: K2's plain version and its host build
over 100 substeps on the CPU, beside the plain version's own noisy runs.

For a state of `tests/torch_common.py:slide_inputs` at 4096 envs (the card
check's size), this runs the plain control step of 100 substeps, ``seeds``
batches of 8 noisy plain runs (`noise_bound`'s runs: -1, 0 or +1 ulp on
every element of the state before each substep, one noise seed per batch)
and the kernel source's host build (tests/kernels_host.cpp, as
tests/test_torch_kernels.py builds it). An env forks where one noisy run
parts from the plain run by more than the other runs' bound (the larger of
2e-3 and twice their spread) allows. Prints one JSON line per forking env,
and per env where the host build lies beyond its bound: each noisy run's
error against the plain run, the host build's, and the host build's
distance to the nearest noisy run.

    python tests/k2_fork_witness.py [state] [seeds]

'cap' and 4 seeds take about 5 minutes on 4 cores.
"""

import ctypes
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from pybullet_multigoal_gym_tpu_torch.ops import cuda_engine  # noqa: E402
from pybullet_multigoal_gym_tpu_torch.ops import dynamics as D  # noqa: E402
from pybullet_multigoal_gym_tpu_torch.ops import scene as S  # noqa: E402
from tests import kernel_ops  # noqa: E402
from tests.torch_common import (plain_run, slide_inputs,  # noqa: E402
                                torch_controls, torch_state)

N_ENVS, N_SUB, RUNS, TOL, FACTOR = 4096, 100, 8, 2e-3, 2.0
HOST_SRC = Path(__file__).resolve().parent / 'kernels_host.cpp'
HOST_FLAGS = ['-std=c++17', '-O0', '-ffp-contract=off', '-shared', '-fPIC']


def errors(a, b):
    """Per-env max |a - b| over q, qd, fq, fqd and the body's state."""
    return torch.stack([(x - y).abs().reshape(x.shape[0], -1).max(1).values
                        for x, y in zip(a[:8], b[:8])]).max(0).values


def host_run(sc, st, ctl):
    so = ctypes.CDLL(str(kernel_ops.host_library(HOST_SRC, HOST_FLAGS)))
    P, I = ctypes.c_void_p, ctypes.c_int
    so.engine_host.argtypes = [I, I, I, P, P, P, P, I, I, I]
    rows, ctl_rows = cuda_engine.pack(st, ctl)
    prm = torch.tensor(cuda_engine.scene_params(sc), dtype=torch.float32)
    out = torch.empty_like(rows)
    assert so.engine_host(*cuda_engine.scene_key(sc), rows.data_ptr(),
                          ctl_rows.data_ptr(), prm.data_ptr(), out.data_ptr(),
                          rows.shape[1], N_SUB, sc.solver_iters) == 0
    return cuda_engine.unpack(out, st)


def main(kind='cap', seeds=4):
    torch.set_num_threads(4)
    t0 = time.time()
    sc = D.scene_consts(S.single_step_scene(True, 'long_table'),
                        ik_workspace=kind != 'sphere')
    st, ctl = slide_inputs(kind, N_ENVS)
    st, ctl = torch_state(st), torch_controls(ctl)
    ref, _ = plain_run(sc, st, ctl, N_SUB)
    errs, runs = [], []
    for seed in range(seeds):
        tile = [type(x)(*(torch.cat([f] * RUNS) for f in x))
                for x in (st, ctl)]
        out = plain_run(sc, *tile, N_SUB, noise_seed=seed)[0]
        for k in range(RUNS):
            run = type(out)(*(f[k * N_ENVS:(k + 1) * N_ENVS] for f in out))
            runs.append(run)
            errs.append(errors(run, ref))
    errs = torch.stack(errs)                       # (runs, envs)
    host = host_run(sc, st, ctl)
    e_host = errors(host, ref)
    spread = errs.max(0).values
    bound = torch.clamp(FACTOR * spread, min=TOL)
    forks = set()
    for k in range(len(errs)):
        others = torch.clamp(FACTOR * torch.cat([errs[:k], errs[k + 1:]])
                             .max(0).values, min=TOL)
        forks |= set(torch.nonzero(errs[k] > others).flatten().tolist())
    beyond = set(torch.nonzero(e_host > bound).flatten().tolist())
    for env in sorted(forks | beyond):
        to_runs = torch.stack([errors(type(r)(*(f[env:env + 1] for f in r)),
                                      type(host)(*(f[env:env + 1]
                                                   for f in host)))[0]
                               for r in runs])
        print(json.dumps(dict(
            state=kind, env=env, fork=env in forks,
            host_beyond_bound=env in beyond, host_err=float(e_host[env]),
            bound=float(bound[env]),
            noisy_errs=[float(x) for x in errs[:, env]],
            runs_parting_over_1e_2=int((errs[:, env] > 1e-2).sum()),
            host_to_nearest_noisy_run=float(to_runs.min()),
            nearest_noisy_run=int(to_runs.argmin()))), flush=True)
    print(json.dumps(dict(
        state=kind, envs=N_ENVS, substeps=N_SUB, noisy_runs=len(errs),
        forking_envs=len(forks), host_envs_beyond_bound=len(beyond),
        host_max_err=float(e_host.max()), seconds=time.time() - t0)),
        flush=True)


if __name__ == '__main__':
    main(*(f(a) for f, a in zip((str, int), sys.argv[1:3])))
