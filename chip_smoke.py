#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's hand-written kernels from `pybullet_multigoal_gym_tpu_torch/
csrc/` (nvcc, sm_90a), holds each against its plain PyTorch version on the
card (on the inputs the main path gives it and on stress inputs), drives the
main path (`make_vec_env(task='push', num_envs=4096)`, 60 steps across one
auto-reset, then reach for 5 steps) and checks that it went through the
kernels. One JSON line per check or phase; the kernels line, the card's
name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Stops at the first failure with a non-zero
exit and no result; exits non-zero without a CUDA device or without the
package beside it. Imports nothing of JAX.
"""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

N_ENVS = 4096
MAIN_STEPS, TIMED_FROM = 60, 10
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 (non-tensor)
# operations/s; a card below 700 W runs slower than these
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12


def emit(phase, **kw):
    print(json.dumps(dict(phase=phase, **kw)), flush=True)


def run(cmd):
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        raise RuntimeError('%s failed: %s' % (cmd[0], out.stderr))
    return out.stdout.strip()


def card_line():
    return run(['nvidia-smi', '--query-gpu=name,power.limit',
                '--format=csv,noheader']).splitlines()[0]


def time_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events), after
    one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes, n_ops):
    """The least time the card could take: bytes over the memory rate or
    operations over the float32 rate, whichever is larger. ``n_ops`` is the
    kernel's own count on this run's inputs (tests/kernel_ops.py: the
    arithmetic the data needs, less masking, selects and sign flips)."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops else 'operations'


def main_path_inputs(torch, port, task, at=(0, 25), seed=2):
    """What K1 and K2 are given on the main path: a seeded drive of ``task``
    at N_ENVS, and at each step index in ``at`` the IK target, its warm
    start and rest pose, the physics state and the controls, taken as
    `VecMGEnv.step` makes them."""
    from pybullet_multigoal_gym_tpu_torch.ops import dynamics as D
    env = port.make_vec_env(num_envs=N_ENVS, task=task, seed=seed)
    core = env.core
    rest = torch.as_tensor(core.rest_pose, device='cuda').expand(N_ENVS, 7)
    state, _ = env.reset()
    g = torch.Generator(device='cuda').manual_seed(seed)
    out = []
    for i in range(max(at) + 1):
        action = 2 * torch.rand((N_ENVS, env.cfg.action_dim), generator=g,
                                device='cuda') - 1
        if i in at:
            dec, f_target = core.step_decode_pre(state, action)
            zero = dec.phys.door_q
            out.append(dict(
                step=i + 1, target=dec.ee_target, q_init=dec.phys.q, rest=rest,
                phys=dec.phys, controls=D.Controls(
                    q_target=core.arm_targets(dec), f_target=f_target,
                    door_motor_on=zero > 0, door_target=zero)))
        state, *_ = env.step(state, action)
    return out


def phase_ik(captured, count_lib):
    """K1 against ops/ik.py:solve on the card: 4096 targets from the IK
    workspace box at 8 and 40 iterations, and the main path's own inputs
    (push and reach) at its 8. The kernel alone is timed on inputs packed
    once (``ms``), and the wrapper's whole call beside it (``call_ms``), on
    the main path's inputs; its operations are counted on the same inputs."""
    import numpy as np
    import torch
    from pybullet_multigoal_gym_tpu_torch.model import kuka_model as KM
    from pybullet_multigoal_gym_tpu_torch.ops import ik
    from pybullet_multigoal_gym_tpu_torch.ops.cuda_ik import CudaIK, pack
    from tests.kernel_ops import ik_ops
    from tests.torch_common import t, workspace_targets
    rng = np.random.default_rng(1)
    tgt = t(workspace_targets(rng, N_ENVS), 'cuda')
    rest = t(KM.KUKA_REST_POSE, 'cuda').expand(N_ENVS, 7)
    q0 = rest + t(rng.uniform(-0.2, 0.2, (N_ENVS, 7)), 'cuda')
    cases = [('workspace box', 8, tgt, q0, rest),
             ('workspace box', 40, tgt, q0, rest)]
    for task, inputs in captured.items():
        for c in inputs:
            cases.append(('%s main path, step %d' % (task, c['step']), 8,
                          c['target'], c['q_init'], c['rest']))
    worst, kernel_ms = 0.0, {}
    for name, iters, tg, q, r in cases:
        w = CudaIK(num_iters=iters)
        err = float((w.solve(tg, q_init=q, rest_pose=r)
                     - ik.solve(tg, q_init=q, rest_pose=r, num_iters=iters)
                     ).abs().max())
        emit('k1_vs_plain', inputs=name, iters=iters, envs=N_ENVS, tol=1e-4,
             max_abs_err=err)
        if not err <= 1e-4:
            raise AssertionError('K1 (%s, %d iterations) disagrees with its '
                                 'plain version: %g' % (name, iters, err))
        worst = max(worst, err)
        # the kernel alone, on inputs packed once (back-to-back launches)
        packed = pack(tg, q_init=q, rest_pose=r)
        out = torch.empty((7, N_ENVS), device='cuda')
        kernel_ms[name, iters] = time_ms(lambda: w.launch(packed, out), 50)

    # the main path's K1 call: push at step 26
    c = captured['push'][-1]
    name = 'push main path, step %d' % c['step']
    tg, q, r = c['target'], c['q_init'], c['rest']
    w = CudaIK(num_iters=8)
    call_ms = time_ms(lambda: w.solve(tg, q_init=q, rest_pose=r), 50)
    plain_ms = time_ms(lambda: ik.solve(tg, q_init=q, rest_pose=r,
                                        num_iters=8), 3)
    ops, _ = ik_ops(count_lib, tg, q_init=q, rest_pose=r, num_iters=8)
    b_ms, b_by = bound_ms(N_ENVS * (21 + 7) * 4, ops)
    res = dict(max_abs_err=worst, ms=kernel_ms[name, 8], call_ms=call_ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, ops=ops)
    emit('k1_timing', inputs=name, iters=8, envs=N_ENVS, **res,
         ms_40_iterations=kernel_ms['workspace box', 40])
    return res


def engine_inputs(has_obj, kind):
    """K2 stress inputs at N_ENVS on the card, made as the port's tests make
    them (tests/torch_common.py): 'drop' is the JAX package's own parity
    state (rest pose, a box dropped beside the fingers); 'contact' holds the
    arm low over the table with the box between the finger pads, so
    finger-box, finger-plane and arm-sphere lanes all act."""
    from tests.torch_common import inputs, torch_controls, torch_state
    st, ctl = inputs(has_obj, kind, N_ENVS)
    return torch_state(st, 'cuda'), torch_controls(ctl, 'cuda')


def env_errors(out, ref, n_fields):
    """Per-env max |out - ref| over the first ``n_fields`` state fields."""
    import torch
    return torch.stack([(a - b).abs().flatten(1).max(1).values
                        for a, b in zip(out[:n_fields], ref[:n_fields])]
                       ).max(0).values


# the K2 checks beyond the main path: (task, control, stress state); the
# joint-control scene keeps every arm-sphere lane
STRESS = (('push', 'ee', 'drop'), ('push', 'ee', 'contact'),
          ('push', 'joint', 'contact'), ('reach', 'ee', 'drop'),
          ('reach', 'ee', 'contact'))
N_NOISE = 8          # plain runs with 1-ulp noise per stress check
SPREAD_FACTOR = 2.0  # an env may part by twice the plain version's spread


def phase_engine(kernels, captured, count_lib):
    """K2 against ops/engine_plain.py on the card.

    - The main path's own inputs (push and reach, steps 1 and 26 of a seeded
      drive): every env within 1e-4 after 2 substeps and within 2e-3 after
      the full 100, the bound the JAX package holds its Pallas engine to
      against its XLA engine. ``lanes_active`` says which lane groups act
      there (per group, the share of envs with an active lane).
    - The stress states (``STRESS``, engine_inputs; 'contact' makes the
      finger-box, finger-plane and sphere-box lanes act), whose impulses
      run to thousands of newtons: there the plain version's own answer
      moves by far more than the tolerance in some envs when rounding moves
      by one ulp. So each env is held to its own bound: within the tolerance
      (1e-4 after 2 substeps, 2e-3 after 100) or within SPREAD_FACTOR times
      its spread over N_NOISE plain runs with 1-ulp noise in every substep
      (tests/torch_common.py:plain_run), whichever is larger.

    Timed on the main path's inputs at step 26: the kernel alone on inputs
    packed once (``ms``), and the wrapper's whole call (``call_ms``); its
    operations are counted on the same inputs."""
    import torch
    from pybullet_multigoal_gym_tpu_torch.ops import dynamics as D
    from pybullet_multigoal_gym_tpu_torch.ops import engine_plain as EP
    from pybullet_multigoal_gym_tpu_torch.ops import scene as S
    from pybullet_multigoal_gym_tpu_torch.ops.cuda_engine import CudaEngine, pack
    from tests.kernel_ops import engine_ops
    from tests.torch_common import plain_run
    engines = {}

    def engine(task, control):
        if (task, control) not in engines:
            sc = D.scene_consts(S.single_step_scene(task == 'push'),
                                ik_workspace=control == 'ee')
            engines[task, control] = sc, CudaEngine(sc)
        return engines[task, control]

    res = {}
    for task in ('push', 'reach'):
        sc, w = engine(task, 'ee')
        n_fields = 8 if task == 'push' else 4    # the box only where it exists
        worst = 0.0
        for c in captured[task]:
            for n_sub, tol in ((2, 1e-4), (100, 2e-3)):
                out = w.control_step(c['phys'], c['controls'], n_substeps=n_sub)
                ref, active = plain_run(sc, c['phys'], c['controls'], n_sub)
                e = env_errors(out, ref, n_fields)
                emit('k2_vs_plain', task=task, control='ee',
                     inputs='main path, step %d' % c['step'], substeps=n_sub,
                     envs=N_ENVS, max_abs_err=float(e.max()), tol=tol,
                     lanes_active=active,
                     max_ee_force=float(out.ee_contact_force.abs().max()))
                if not e.max() <= tol:
                    raise AssertionError(
                        'K2 (%s, main path step %d, %d substeps) disagrees '
                        'with its plain version: %g'
                        % (task, c['step'], n_sub, float(e.max())))
                worst = max(worst, float(e.max()))
        res[task] = dict(max_abs_err=worst)

    for task, control, kind in STRESS:
        sc, w = engine(task, control)
        n_fields = 8 if task == 'push' else 4
        st, ctl = engine_inputs(task == 'push', kind)
        for n_sub, tol in ((2, 1e-4), (100, 2e-3)):
            out = w.control_step(st, ctl, n_substeps=n_sub)
            ref, active = plain_run(sc, st, ctl, n_sub)
            e = env_errors(out, ref, n_fields)
            spread = torch.stack([
                env_errors(plain_run(sc, st, ctl, n_sub, seed)[0], ref,
                           n_fields) for seed in range(N_NOISE)]).max(0).values
            bound = torch.clamp(SPREAD_FACTOR * spread, min=tol)
            beyond = torch.nonzero(e > bound).flatten()
            emit('k2_vs_plain', task=task, control=control, inputs=kind,
                 substeps=n_sub, envs=N_ENVS, max_abs_err=float(e.max()),
                 median_abs_err=float(e.median()), tol=tol,
                 envs_beyond_tol=int((e > tol).sum()),
                 plain_noise_envs_beyond_tol=int((spread > tol).sum()),
                 plain_noise_max_spread=float(spread.max()),
                 max_share_of_env_bound=float((e / bound).max()),
                 envs_beyond_env_bound=int(beyond.numel()),
                 lanes_active=active,
                 max_ee_force=float(out.ee_contact_force.abs().max()))
            if beyond.numel():
                b = beyond[:8]
                raise AssertionError(
                    'K2 (%s, %s control, %s state, %d substeps) disagrees '
                    'with its plain version in envs %s: %s against their '
                    'bounds %s' % (task, control, kind, n_sub, b.tolist(),
                                   e[b].tolist(), bound[b].tolist()))

    for task in ('push', 'reach'):
        sc, w = engine(task, 'ee')
        c = captured[task][-1]
        st, ctl = c['phys'], c['controls']
        # the kernel alone, on inputs packed once, and the wrapper's call
        rows, ctl_rows = pack(st, ctl)
        out = torch.empty_like(rows)
        ms = time_ms(lambda: w.launch(rows, ctl_rows, out, 100), 10)
        call_ms = time_ms(lambda: w.control_step(st, ctl), 10)
        plain_ms = time_ms(lambda: EP.control_step(sc, st, ctl, 100), 1)
        ops, _ = engine_ops(count_lib, sc, st, ctl, 100)
        b_ms, b_by = bound_ms(N_ENVS * (34 + 9 + 34) * 4, ops)
        res[task].update(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, ops=ops)
        emit('k2_timing', task=task, inputs='main path, step %d' % c['step'],
             substeps=100, envs=N_ENVS, **res[task],
             ptxas=kernels['engine'].ptxas)
    return res


def drive(torch, port, task, steps, seed):
    """``steps`` env steps of seeded actions through the public entry point;
    the kernel launch counts are zeroed just before and read just after."""
    env = port.make_vec_env(num_envs=N_ENVS, task=task, seed=seed)
    state, obs = env.reset()
    g = torch.Generator(device='cuda').manual_seed(seed)
    actions = 2 * torch.rand((steps, N_ENVS, env.cfg.action_dim), generator=g,
                             device='cuda') - 1
    dims = {k: tuple(v.shape) for k, v in obs.items()}
    done_at = []
    finite = torch.ones((), dtype=torch.bool, device='cuda')
    env.core.ik.launches = env.core.engine.launches = 0
    torch.cuda.synchronize()
    t0 = None
    for i in range(steps):
        if i == TIMED_FROM:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, obs, reward, done, info = env.step(state, actions[i])
        done_at.append(done)
        for v in obs.values():
            finite &= torch.isfinite(v).all()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0 if t0 is not None else None
    launches = dict(ik=env.core.ik.launches, engine=env.core.engine.launches)
    done_steps = [i + 1 for i, d in enumerate(done_at) if bool(d.any())]
    all_done = [i + 1 for i, d in enumerate(done_at) if bool(d.all())]
    shapes_ok = {k: tuple(v.shape) for k, v in obs.items()} == dims
    rate = (steps - TIMED_FROM) * N_ENVS / elapsed if elapsed else None
    return env, state, dict(task=task, envs=N_ENVS, steps=steps,
                            launches=launches, done_steps=done_steps,
                            all_done_steps=all_done, obs_finite=bool(finite),
                            obs_shapes=dims, shapes_ok=shapes_ok,
                            env_steps_per_s=rate)


def phase_main(torch, port):
    """The main path: push@4096 for 60 steps (auto-reset at step 50), then
    the same 64 envs stepped once on the card and on the CPU from one state,
    then reach@4096 for 5 steps."""
    from pybullet_multigoal_gym_tpu_torch import interop
    card = card_line()
    env, state, res = drive(torch, port, 'push', MAIN_STEPS, seed=0)
    emit('main_path', card=card, **res)
    want = dict(ik=MAIN_STEPS, engine=MAIN_STEPS)
    if not (res['obs_finite'] and res['shapes_ok']
            and res['done_steps'] == [50] and res['all_done_steps'] == [50]
            and res['launches'] == want):
        raise AssertionError('main path check failed: %s' % res)

    # the kernels' path against the plain path on a small input
    leaves = {k: v[:64] for k, v in interop.state_to_numpy(state).items()}
    g = torch.Generator().manual_seed(5)
    action = 2 * torch.rand((64, env.cfg.action_dim), generator=g) - 1
    obs = {}
    for dev in ('cuda', 'cpu'):
        e = port.make_vec_env(num_envs=64, task='push', device=dev)
        s = interop.state_from_numpy(leaves, device=dev)
        _, o, _, _, _ = e.step(s, action.to(dev))
        obs[dev] = o['observation'].cpu()
    err = float((obs['cuda'] - obs['cpu']).abs().max())
    emit('main_path_vs_plain', task='push', envs=64, steps=1,
         max_abs_err_obs=err, tol=5e-3)
    if not err <= 5e-3:
        raise AssertionError('kernel path disagrees with the plain path: %g'
                             % err)

    _, _, reach = drive(torch, port, 'reach', 5, seed=1)
    emit('reach_path', **reach)
    if not (reach['obs_finite'] and reach['shapes_ok']
            and reach['launches'] == dict(ik=5, engine=5)):
        raise AssertionError('reach path check failed: %s' % reach)
    return res


def main():
    here = Path(__file__).resolve().parent
    if not (here / 'pybullet_multigoal_gym_tpu_torch').is_dir():
        print('chip_smoke: the pybullet_multigoal_gym_tpu_torch package is '
              'not beside this script', file=sys.stderr)
        return 1
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    import pybullet_multigoal_gym_tpu_torch as port
    from pybullet_multigoal_gym_tpu_torch.ops import _build

    emit('env', card=card_line(), torch=torch.__version__,
         cuda=torch.version.cuda,
         nvcc=run([_build.nvcc_path(), '--version']).splitlines()[-1],
         device_count=torch.cuda.device_count())

    # build from the checkout's sources, every kernel at once, and beside
    # them the host build that counts the kernels' operations
    from tests import kernel_ops
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    counting = kernel_ops.build(_build.BUILD_DIR / 'count', start_only=True)
    kernels = _build.build_all()
    count_lib = kernel_ops.load(counting)
    emit('build', seconds=time.perf_counter() - t0,
         kernels={k: dict(source=str(v.path.name), ptxas=v.ptxas)
                  for k, v in kernels.items()})

    captured = {task: main_path_inputs(torch, port, task)
                for task in ('push', 'reach')}
    ik_res = phase_ik(captured, count_lib)
    eng_res = phase_engine(kernels, captured, count_lib)
    main_res = phase_main(torch, port)

    launches = main_res['launches']
    k1, k2 = ik_res, eng_res['push']
    print(json.dumps({'kernels': [
        dict(name='K1 batched DLS IK (8 iterations)', route='cuda',
             source='pybullet_multigoal_gym_tpu_torch/csrc/ik.cu',
             replaces='pybullet_multigoal_gym_tpu/ops/pallas_ik.py:90',
             launches=launches['ik'], max_abs_err=k1['max_abs_err'],
             ms=k1['ms'], plain_ms=k1['plain_ms'], bound_ms=k1['bound_ms'],
             bound_by=k1['bound_by'], library_ms=None),
        dict(name='K2 fused control step (push, 100 substeps)', route='cuda',
             source='pybullet_multigoal_gym_tpu_torch/csrc/engine.cu',
             replaces='pybullet_multigoal_gym_tpu/ops/pallas_engine.py:497',
             launches=launches['engine'],
             # over the main path's inputs (the stress states are held
             # to each env's own bound: see k2_vs_plain)
             max_abs_err=max(r['max_abs_err'] for r in eng_res.values()),
             ms=k2['ms'], plain_ms=k2['plain_ms'], bound_ms=k2['bound_ms'],
             bound_by=k2['bound_by'], library_ms=None),
    ]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
