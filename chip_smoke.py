#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's hand-written kernels from `pybullet_multigoal_gym_tpu_torch/
csrc/` (nvcc, sm_90a), holds each against its plain PyTorch version on the
card (on the inputs the main paths give it and on stress inputs), drives the
main paths and checks that they went through the kernels: push
(`make_vec_env(task='push', num_envs=4096)`, 60 steps across one auto-reset,
then reach for 5 steps) on K1 and K2, block_rearrange with 2 blocks (4096
envs, 60 steps across one auto-reset) and block_stack with 5 (1024 envs) on
K1 and K3, and the push primitives (primitive_push_assemble with
discrete_push and primitive_push_reach with continuous_push, 1024 envs: 20
K1 launches at 16 iterations and 20 K3 launches of 80 substeps per step) on
K1 and K3's bodies of several geoms, insertion (1024 envs, 60 steps
across one auto-reset: K1 toward a rotation target, K3 with a pinned body)
on K1 and K3's pinned-body lanes, slide (4096 envs, 60 steps across one
auto-reset, and a scripted strike through `make_env`'s single-env adapter
under joint control) on K1 and K2's cylinder lanes, and the chest tasks
(chest_push with 4 and 2 blocks at 1024 envs for 60 steps across one
auto-reset, chest_pick_and_place for 5, its 558-lane joint-control plan for
one, and a door-opening drive) on K1 and K3's static-wall and door lanes;
and with the Robotiq-85 gripper (`gripper='robotiq85'`) push and
block_rearrange with 2 blocks at 4096 envs for 60 steps across one
auto-reset, on K1 toward its tip and K2's and K3's Robotiq instances,
with the JAX package's grasp-and-lift at 1024 copies.
One JSON line per check or phase, each
with the ``seconds`` since the line before it; the kernels line, the card's
name and power limit, and as the last line ``{"ok": true, "device":
{...}}``. Stops at the first failure with a non-zero exit and no result;
exits non-zero without a CUDA device or without the package beside it.
Imports nothing of JAX.
"""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

N_ENVS = 4096
MAIN_STEPS, TIMED_FROM = 60, 10
# block_stack with 5 blocks runs at 1024 envs (the README's configuration)
STACK_ENVS, STACK_STEPS, STACK_TIMED_FROM = 1024, 20, 5
# the push primitives too; one step is 20 sub-targets of 80 substeps each
PRIM_ENVS, PRIM_STEPS, PRIM_TIMED_FROM = 1024, 12, 2
PRIM_SUBSTEPS, PRIM_LAUNCHES = 80, 20
# insertion runs at 1024 envs (the README's configuration)
INS_ENVS, INS_STEPS, INS_TIMED_FROM = 1024, MAIN_STEPS, TIMED_FROM
# chest_push with 4 blocks and 2 runs at 1024 envs (the README's
# configurations), chest_pick_and_place too; the door-opening drive runs
# until its sweep has ended in every env or for this many steps
CHEST_ENVS, CHEST_STEPS, CHEST_TIMED_FROM = 1024, MAIN_STEPS, TIMED_FROM
DOOR_DRIVE_STEPS = 150
# slide's scripted strike: episodes of the single-env adapter, and their
# length (tests/test_acceptance.py:test_slide_scripted)
STRIKE_EPISODES, STRIKE_STEPS = 4, 150
# the lowest the puck's centre may go in any step of the strike (it rests
# at 0.170): a pad riding onto its cap presses it into the table. On this
# strike's own states the JAX package's engine takes it to 0.1492 and the
# port's plain version to 0.1557 (PERF.md, PR 8: tests/slide_strike_pair.py)
STRIKE_FLOOR_Z = 0.14
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 (non-tensor)
# operations/s; a card below 700 W runs slower than these
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12


_LAST_LINE = [time.perf_counter()]


def emit(phase, **kw):
    """One JSON line, with the seconds since the line before it."""
    now = time.perf_counter()
    print(json.dumps(dict(phase=phase, **kw,
                          seconds=now - _LAST_LINE[0])), flush=True)
    _LAST_LINE[0] = now


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


def actions(torch, env, g, shape):
    """Seeded actions for ``env`` from generator ``g``: uniform in [-1, 1],
    or cells of the action map (`MultiDiscrete`) for discrete_push."""
    if env.cfg.primitive == 'discrete_push':
        nvec = torch.tensor(env.action_space.nvec, dtype=torch.float32,
                            device=g.device)
        return torch.floor(torch.rand(shape + (3,), generator=g,
                                      device=g.device) * nvec)
    return 2 * torch.rand(shape + (env.cfg.action_dim,), generator=g,
                          device=g.device) - 1


def main_path_inputs(torch, port, task, at=(0, 25), seed=2, num_envs=N_ENVS,
                     **kw):
    """What K1 and the control-step kernel are given on a main path: a
    seeded drive of ``task`` at ``num_envs``, and at each step index in
    ``at`` the IK target (position, and orientation where the task
    controls it), its warm start and rest pose, the physics state and the
    controls, taken as `VecMGEnv.step` makes them."""
    from pybullet_multigoal_gym_tpu_torch.maths import quat as Q
    from pybullet_multigoal_gym_tpu_torch.ops import dynamics as D
    env = port.make_vec_env(num_envs=num_envs, task=task, seed=seed, **kw)
    core = env.core
    rest = torch.as_tensor(core.rest_pose, device='cuda').expand(num_envs, 7)
    state, _ = env.reset()
    g = torch.Generator(device='cuda').manual_seed(seed)
    # the chest door's hold-open motor, as VecMGEnv.step drives it
    door_target = (env.cfg.chest_door_opened_state if env.cfg.has_chest
                   else 0.0)
    out = []
    for i in range(max(at) + 1):
        action = actions(torch, env, g, (num_envs,))
        if i in at:
            dec, f_target = core.step_decode_pre(state, action)
            out.append(dict(
                step=i + 1, target=dec.ee_target, q_init=dec.phys.q, rest=rest,
                target_quat=(Q.euler_zyz_to_quat(dec.ee_target_rot)
                             if env.cfg.end_effector_rotation_control
                             else None),
                phys=dec.phys, scene=core.scene, controls=D.Controls(
                    q_target=core.arm_targets(dec), f_target=f_target,
                    door_motor_on=dec.door_hold_open,
                    door_target=torch.full_like(dec.phys.door_q,
                                                door_target))))
        state, *_ = env.step(state, action)
    return out


class _Recorder:
    """Stands in for an env's K1 or K3 wrapper during a capture drive: notes
    each call's arguments and passes the call on."""

    def __init__(self, inner):
        self.inner, self.calls = inner, []

    def solve(self, *args, **kw):
        self.calls.append((args, kw))
        return self.inner.solve(*args, **kw)

    def control_step(self, *args, **kw):
        self.calls.append((args, kw))
        return self.inner.control_step(*args, **kw)


def primitive_main_inputs(torch, port, seed=2):
    """What K1 and K3 are given on the primitive main path: step 1 of a
    seeded primitive_push_assemble drive (discrete_push) at PRIM_ENVS,
    recorded call by call. Returns sub-target 1 and the sub-target whose
    start has the most envs with a finger pad on an object (a finger-box
    lane active), each as main_path_inputs gives its captures."""
    from pybullet_multigoal_gym_tpu_torch.ops import engine_plain as EP
    from pybullet_multigoal_gym_tpu_torch.ops import multibody_plain as MP
    env = port.make_vec_env(num_envs=PRIM_ENVS, task='primitive_push_assemble',
                            primitive='discrete_push', seed=seed)
    core = env.core
    state, _ = env.reset()
    g = torch.Generator(device='cuda').manual_seed(seed)
    wrappers = core.ik, core.engine
    core.ik, core.engine = _Recorder(core.ik), _Recorder(core.engine)
    try:
        env.step(state, actions(torch, env, g, (PRIM_ENVS,)))
        ik_calls, engine_calls = core.ik.calls, core.engine.calls
    finally:
        core.ik, core.engine = wrappers
    sc = core.scene
    pads = [k for k, lane in enumerate(MP.lane_plan(sc))
            if MP.lane_group(lane) == 'finger-box']
    contact = []
    for (phys, _), _ in engine_calls:
        act = MP.build_lanes(sc, EP.fk_chain(phys.q, phys.fq), phys.body_pos,
                             phys.body_quat, EP.qmat(phys.body_quat))[3]
        contact.append(float((act[:, pads] > 0).any(1).float().mean()))
    most = max(range(len(contact)), key=contact.__getitem__)
    out = []
    for k in sorted({0, most}):
        (target,), ik_kw = ik_calls[k]
        (phys, controls), _ = engine_calls[k]
        out.append(dict(step=1, sub_target=k + 1, pad_contact=contact[k],
                        target=target, q_init=ik_kw['q_init'],
                        rest=ik_kw['rest_pose'], phys=phys, scene=sc,
                        controls=controls))
    emit('primitive_capture', envs=PRIM_ENVS, step=1,
         sub_targets=[c['sub_target'] for c in out],
         pad_contact_share=[c['pad_contact'] for c in out])
    return out


def primitive_name(c):
    return 'primitive_push_assemble main path, step %d, sub-target %d' % (
        c['step'], c['sub_target'])


def phase_ik(captured, count_lib):
    """K1 against ops/ik.py:solve on the card: 4096 targets from the IK
    workspace box at 8 and 40 iterations, the main path's own inputs
    (push and reach) at its 8, the primitive main path's own inputs (1024
    envs) at its 16, and insertion's (1024 envs) at its 8, toward the
    orientation of the ZYZ accumulator. The kernel alone is timed on inputs
    packed once (``ms``), and the wrapper's whole call beside it
    (``call_ms``), on push's, the primitive's and insertion's inputs; its
    operations are counted on the same inputs. Returns push's figures, with
    insertion's under 'insertion'."""
    import numpy as np
    import torch
    from pybullet_multigoal_gym_tpu_torch.envs.shape_assemble import (
        PRIMITIVE_IK_ITERS)
    from pybullet_multigoal_gym_tpu_torch.model import kuka_model as KM
    from pybullet_multigoal_gym_tpu_torch.ops import ik
    from pybullet_multigoal_gym_tpu_torch.ops.cuda_ik import CudaIK, pack
    from tests.kernel_ops import ik_ops
    from tests.torch_common import t, workspace_targets
    rng = np.random.default_rng(1)
    tgt = t(workspace_targets(rng, N_ENVS), 'cuda')
    rest = t(KM.KUKA_REST_POSE, 'cuda').expand(N_ENVS, 7)
    q0 = rest + t(rng.uniform(-0.2, 0.2, (N_ENVS, 7)), 'cuda')
    cases = [('workspace box', 8, tgt, None, q0, rest),
             ('workspace box', 40, tgt, None, q0, rest)]
    for task, inputs in captured.items():
        for c in inputs:
            if task == 'primitive':
                cases.append((primitive_name(c), PRIMITIVE_IK_ITERS,
                              c['target'], None, c['q_init'], c['rest']))
            elif c['target'].shape[0] == N_ENVS or task == 'insertion':
                cases.append(('%s main path, step %d' % (task, c['step']), 8,
                              c['target'], c['target_quat'], c['q_init'],
                              c['rest']))
    worst, worst_ins, kernel_ms = 0.0, 0.0, {}
    for name, iters, tg, tq, q, r in cases:
        w = CudaIK(num_iters=iters)
        err = float((w.solve(tg, tq, q_init=q, rest_pose=r)
                     - ik.solve(tg, tq, q_init=q, rest_pose=r,
                                num_iters=iters)).abs().max())
        emit('k1_vs_plain', inputs=name, iters=iters, envs=tg.shape[0],
             rotation_target=tq is not None, tol=1e-4, max_abs_err=err)
        if not err <= 1e-4:
            raise AssertionError('K1 (%s, %d iterations) disagrees with its '
                                 'plain version: %g' % (name, iters, err))
        if name.startswith('insertion'):
            worst_ins = max(worst_ins, err)
        else:
            worst = max(worst, err)
        # the kernel alone, on inputs packed once (back-to-back launches)
        packed = pack(tg, tq, rest_pose=r, q_init=q)
        out = torch.empty((7, tg.shape[0]), device='cuda')
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

    # the primitive's K1 call: sub-target 1 of step 1, 20 such per env step
    c = captured['primitive'][0]
    name = primitive_name(c)
    tg, q, r = c['target'], c['q_init'], c['rest']
    w = CudaIK(num_iters=PRIMITIVE_IK_ITERS)
    ops, _ = ik_ops(count_lib, tg, q_init=q, rest_pose=r,
                    num_iters=PRIMITIVE_IK_ITERS)
    b_ms, b_by = bound_ms(PRIM_ENVS * (21 + 7) * 4, ops)
    emit('k1_timing', inputs=name, iters=PRIMITIVE_IK_ITERS, envs=PRIM_ENVS,
         launches_per_env_step=PRIM_LAUNCHES,
         ms=kernel_ms[name, PRIMITIVE_IK_ITERS],
         call_ms=time_ms(lambda: w.solve(tg, q_init=q, rest_pose=r), 50),
         plain_ms=time_ms(lambda: ik.solve(tg, q_init=q, rest_pose=r,
                                           num_iters=PRIMITIVE_IK_ITERS), 3),
         bound_ms=b_ms, bound_by=b_by, ops=ops)

    # insertion's K1 call at step 26, toward a rotation target
    c = captured['insertion'][-1]
    name = 'insertion main path, step %d' % c['step']
    tg, tq, q, r = c['target'], c['target_quat'], c['q_init'], c['rest']
    w = CudaIK(num_iters=8)
    ops, _ = ik_ops(count_lib, tg, tq, rest_pose=r, q_init=q, num_iters=8)
    b_ms, b_by = bound_ms(INS_ENVS * (21 + 7) * 4, ops)
    res['insertion'] = dict(
        max_abs_err=worst_ins, ms=kernel_ms[name, 8],
        call_ms=time_ms(lambda: w.solve(tg, tq, q_init=q, rest_pose=r), 50),
        plain_ms=time_ms(lambda: ik.solve(tg, tq, q_init=q, rest_pose=r,
                                          num_iters=8), 3),
        bound_ms=b_ms, bound_by=b_by, ops=ops)
    emit('k1_timing', inputs=name, iters=8, envs=INS_ENVS,
         rotation_target=True, **res['insertion'])
    return res


def engine_inputs(has_obj, kind):
    """K2 stress inputs at N_ENVS on the card, made as the port's tests make
    them (tests/torch_common.py): 'drop' is the JAX package's own parity
    state (rest pose, a box dropped beside the fingers); 'contact' holds the
    arm low over the table with the box between the finger pads, so
    finger-box, finger-plane and arm-sphere lanes all act; 'sphere' lowers a
    wrist or elbow sphere onto the table (joint control)."""
    from tests.torch_common import inputs, torch_controls, torch_state
    st, ctl = inputs(has_obj, kind, N_ENVS)
    return torch_state(st, 'cuda'), torch_controls(ctl, 'cuda')


def env_errors(out, ref, n_fields):
    """Per-env max |out - ref| over the first ``n_fields`` state fields."""
    import torch
    return torch.stack([(a - b).abs().reshape(a.shape[0], -1).max(1).values
                        for a, b in zip(out[:n_fields], ref[:n_fields])]
                       ).max(0).values


# the K2 checks beyond the main path: (task, control, stress state); the
# joint-control scene keeps every arm-sphere lane. The drop states, the
# least contact-rich, are checked after 2 substeps only (the card tests
# hold them after 100 too).
STRESS = (('push', 'ee', 'drop'), ('push', 'ee', 'contact'),
          ('push', 'joint', 'contact'), ('push', 'joint', 'sphere'),
          ('reach', 'ee', 'drop'), ('reach', 'ee', 'contact'))
N_NOISE = 8          # plain runs with 1-ulp noise per stress check
SPREAD_FACTOR = 2.0  # an env may part by twice the plain version's spread
FLAT = ((2, 1e-4), (100, 2e-3))   # substeps, and the flat bound after them
# the primitive's control step is one sub-target's 80 substeps
PRIM_FLAT = ((2, 1e-4), (PRIM_SUBSTEPS, 2e-3))


def main_path_check(phase, sc, w, c, n_fields, substeps=FLAT, **tag):
    """A control-step kernel against its plain version on a main path's own
    inputs ``c`` (main_path_inputs), after ``substeps``: every env within
    the flat bound (FLAT). Where an env parts by more (the fingers push a
    block, and the plain version's own noisy runs part by more too), that
    env is held to its noise bound (tests/torch_common.py:noise_bound) and
    none may lie beyond it. Returns the largest error."""
    worst = 0.0
    for n_sub, tol in substeps:
        out, ref, active, e = compare(sc, w, c['phys'], c['controls'],
                                      n_fields, n_sub)
        noise = (noise_check(sc, c['phys'], c['controls'], n_sub, ref,
                             n_fields, tol)[:2] + (0, 1.0)
                 if e.max() > tol else None)
        held(phase, sc, n_sub, tol, out, e, active, noise,
             inputs=main_path_name(c), **tag)
        worst = max(worst, float(e.max()))
    return worst


def main_path_name(c):
    """The inputs' name in a check's line: a stress state's own, or the
    main path's step (and sub-target)."""
    if 'inputs' in c:
        return c['inputs']
    name = 'main path, step %d' % c['step']
    return name + (', sub-target %d' % c['sub_target']
                   if 'sub_target' in c else '')


def forced_check(phase, sc, w, c, n_fields, n_sub, tol=1e-4, **tag):
    """A control-step kernel against its plain version in every substep of
    a control step ``c`` (a main path's own inputs, or a stress state's),
    each from the plain version's own state: the plain trajectory's state
    before each of ``n_sub`` substeps
    (tests/torch_common.py:plain_trajectory), all given to the kernel in one
    launch of one substep, and each env's state after it within ``tol`` of
    the plain trajectory's next state, in every env and substep (``envs``
    in the line counts env-substeps). A free run can be chaotic (the push
    primitive's slot rocks on the plate, and where a rocking corner lands
    is settled on the last bit), so after it an env can lie beyond the
    plain version's noise bound while the arithmetic of every substep
    agrees; this check holds that arithmetic with no noise bound, and
    `free_reading` prints the free run. Returns the largest error."""
    import torch
    from tests.torch_common import plain_trajectory
    ctl = c['controls']
    states = plain_trajectory(sc, c['phys'], ctl, n_sub)

    def stack(xs):      # NamedTuples of (N, ...) -> one of (len(xs) N, ...)
        return type(xs[0])(*(torch.cat(f) for f in zip(*xs)))

    out, _, active, e = compare(sc, w, stack(states[:-1]),
                                stack([ctl] * n_sub), n_fields, 1)
    held(phase, sc, 1, tol, out, e, active, None, inputs=main_path_name(c),
         from_plain_trajectory_substeps=n_sub, **tag)
    return float(e.max())


def free_reading(phase, sc, w, c, n_fields, n_sub, tol, **tag):
    """The free run beside `forced_check`: the kernel's and the plain
    version's ``n_sub`` substeps from ``c``, each env against the flat
    bound ``tol`` and its noise bound, printed and not held (`held` with
    ``gate`` off). Returns the largest error."""
    out, ref, active, e = compare(sc, w, c['phys'], c['controls'], n_fields,
                                  n_sub)
    noise = noise_check(sc, c['phys'], c['controls'], n_sub, ref, n_fields,
                        tol)[:2] + (0, 1.0)
    held(phase, sc, n_sub, tol, out, e, active, noise, gate=False,
         inputs=main_path_name(c), **tag)
    return float(e.max())


def chaotic_check(phase, sc, w, c, n_fields, n_sub=100, **tag):
    """A main path whose free run of ``n_sub`` substeps forks on the last
    bit (the plain version's own noisy runs part by more than the flat
    bound): every env after 2 substeps (`main_path_check`), then each
    substep from the plain trajectory's state (`forced_check`), and the
    free run printed (`free_reading`). Returns the largest gated error and
    the free run's."""
    gated = max(main_path_check(phase, sc, w, c, n_fields, substeps=FLAT[:1],
                                **tag),
                forced_check(phase, sc, w, c, n_fields, n_sub, **tag))
    free = free_reading(phase.split('_vs_')[0] + '_free_run_reading', sc, w,
                        c, n_fields, n_sub, FLAT[1][1], **tag)
    return gated, free


def stress_check(phase, sc, w, st, ctl, n_fields, substeps=FLAT, **tag):
    """A control-step kernel against its plain version on a stress state
    after ``substeps``: each env within the flat bound or SPREAD_FACTOR
    times its spread over N_NOISE plain runs with 1-ulp noise
    (tests/torch_common.py:noise_bound), whichever is larger. K2: no env
    beyond it. K3 (block piles, where a pad and a block face lie nearly
    parallel and the SAT axis choice is a tie, the pads pressing the cube
    into the slot, the insertion states): as many envs as a noisy plain
    run itself puts beyond the other runs' bound, each within the largest
    share of that bound such a run reaches. Returns, per lane group, the
    largest share of envs where it acts over ``substeps``."""
    from pybullet_multigoal_gym_tpu_torch.ops import dynamics as D
    shares = {}
    for n_sub, tol in substeps:
        out, ref, active, e = compare(sc, w, st, ctl, n_fields, n_sub)
        noise = noise_check(sc, st, ctl, n_sub, ref, n_fields, tol)
        if not isinstance(sc, D.MultiBodyConsts):
            noise = noise[:2] + (0, 1.0)
        held(phase, sc, n_sub, tol, out, e, active, noise, **tag)
        if tag.get('inputs') == 'sphere' and not active['sphere-plane'] > 0:
            raise AssertionError('the sphere state activates no sphere-plane '
                                 'lane: %s' % active)
        for k, v in active.items():
            shares[k] = max(shares.get(k, 0.0), v)
    return shares


def compare(sc, w, st, ctl, n_fields, n_sub):
    """The kernel's and the plain version's control step from one state:
    (kernel's state, plain state, lanes_active, per-env max |difference|)."""
    from tests.torch_common import plain_run
    out = w.control_step(st, ctl, n_substeps=n_sub)
    ref, active = plain_run(sc, st, ctl, n_sub)
    return out, ref, active, env_errors(out, ref, n_fields)


def noise_check(sc, st, ctl, n_sub, ref, n_fields, tol):
    """(bound, spread, allowed, cap) of tests/torch_common.py:noise_bound
    over N_NOISE noisy plain runs."""
    from tests.torch_common import noise_bound
    return noise_bound(sc, st, ctl, n_sub, ref,
                       lambda a, b: env_errors(a, b, n_fields), tol, N_NOISE,
                       SPREAD_FACTOR)


def held(phase, sc, n_sub, tol, out, e, active, noise, gate=True, **tag):
    """Emit a kernel check's line and, with ``gate``, fail it: ``noise`` is
    None (every env held to ``tol``) or (bound, spread, allowed, cap) from
    noise_check."""
    import torch
    from pybullet_multigoal_gym_tpu_torch.ops import dynamics as D
    bound, spread, allowed, cap = noise or (torch.full_like(e, tol), None,
                                            0, 1.0)
    share = e / bound
    beyond = torch.nonzero(share > 1).flatten()
    extra = {} if spread is None else dict(
        plain_noise_envs_beyond_tol=int((spread > tol).sum()),
        plain_noise_max_spread=float(spread.max()),
        envs_beyond_allowed=allowed, share_allowed=cap)
    emit(phase, **tag, substeps=n_sub, envs=e.shape[0],
         max_abs_err=float(e.max()), median_abs_err=float(e.median()),
         tol=tol, envs_beyond_tol=int((e > tol).sum()), **extra,
         max_share_of_env_bound=float(share.max()),
         envs_beyond_env_bound=int(beyond.numel()), lanes_active=active,
         max_ee_force=float(out.ee_contact_force.abs().max()))
    if gate and (beyond.numel() > allowed or share.max() > cap):
        b = beyond[:8]
        raise AssertionError(
            '%s (%s, %d substeps) disagrees with its plain version in envs '
            '%s: %s against their bounds %s (%d envs and a share of %g '
            'allowed)' % ('K3' if isinstance(sc, D.MultiBodyConsts) else 'K2',
                          tag, n_sub, b.tolist(), e[b].tolist(),
                          bound[b].tolist(), allowed, cap))


def phase_engine(kernels, captured, count_lib):
    """K2 against ops/engine_plain.py on the card.

    - The main path's own inputs (push and reach, steps 1 and 26 of a seeded
      drive): every env within 1e-4 after 2 substeps and within 2e-3 after
      the full 100, the bound the JAX package holds its Pallas engine to
      against its XLA engine (`main_path_check`). ``lanes_active`` says
      which lane groups act there (per group, the share of envs with an
      active lane).
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
        res[task] = dict(max_abs_err=max(
            main_path_check('k2_vs_plain', sc, w, c, n_fields, task=task,
                            control='ee') for c in captured[task]))

    for task, control, kind in STRESS:
        sc, w = engine(task, control)
        n_fields = 8 if task == 'push' else 4
        st, ctl = engine_inputs(task == 'push', kind)
        stress_check('k2_vs_plain', sc, w, st, ctl, n_fields,
                     substeps=FLAT[:1] if kind == 'drop' else FLAT,
                     task=task, control=control, inputs=kind)

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


# the K3 checks beyond the main path: (blocks, control, stress state); the
# joint-control scene keeps every arm-sphere lane
K3_STRESS = ((2, 'ee', 'contact'), (5, 'ee', 'contact'), (2, 'joint', 'sphere'))
N_FIELDS = 8        # q, qd, fq, fqd and the bodies' pos, quat, linvel, angvel
CHEST_FIELDS = 10   # and the door's q and qd
# the chest's stress checks, 2 blocks (tests/torch_common.py:chest_inputs):
# (task, state, substeps); each state after 2 substeps, the block pressed
# against chest_push's door after 100 too (the card tests hold it there,
# and chest_push's main path after 100)
CHEST_STRESS = tuple(
    (task, kind, FLAT if (task, kind) == ('chest_push', 'door_block')
     else FLAT[:1])
    for task in ('chest_push', 'chest_pick_and_place')
    for kind in ('drop', 'handle', 'door_block', 'hold_open', 'spawn'))
# the lane groups the chest brings, each to act in some chest stress state
CHEST_GROUPS = ('box-static', 'box-door', 'finger-door', 'finger-static',
                'sphere-static', 'sphere-door')


def phase_multibody(kernels, captured, count_lib):
    """K3 against ops/multibody_plain.py on the card.

    - The main paths' own inputs (block_rearrange with 2 blocks at steps 1
      and 26 of a seeded drive at 4096 envs, block_stack with 5 at step 26
      at 1024): every env within 1e-4 after 2 substeps and within 2e-3 after
      the full 100, but where the fingers push a block and the plain
      version's own noisy runs part by more than that; there the env is
      held to its noise bound (`main_path_check`). ``lanes_active`` says
      which lane groups act.
    - The primitive main path's own inputs (primitive_push_assemble, step
      1 at 1024 envs, the sub-target with the most pads on an object):
      `main_path_check` after 2 substeps, and in each of the 80 substeps
      from the plain trajectory's state (`forced_check`); the free run's
      80 substeps are printed (`free_reading`). See `phase_primitive_k3`.
    - The stress states (``K3_STRESS``: the block pile the fingers squeeze,
      and a wrist or elbow sphere on the table under joint control; the
      primitive's 'press' state, tests/torch_common.py:primitive_inputs,
      where the pads push the cube into the slot's mouth so that the
      box-box lanes of the slot's side geoms act): each env within the flat
      bound or SPREAD_FACTOR times its spread over N_NOISE noisy plain
      runs, whichever is larger, with the count and cap of envs beyond it
      that `stress_check` allows K3.
    - Insertion's main path and stress states, where the pinned-body lanes
      act (`phase_insertion_k3`).

    Timed on both block main paths' and insertion's step-26 inputs (100
    substeps) and on the primitive's contact sub-target (80): the kernel
    alone on inputs packed once (``ms``) and the wrapper's whole call
    (``call_ms``); the operations are counted on the same inputs
    (`k3_timing`). The chest's checks and timing come after every other
    K3 launch (`phase_chest_k3`): the runtime keeps per-thread local memory
    for the largest stack launched so far, and the larger reservation of a
    chest kernel moves other kernels' times (the primitive's by up to 6
    %)."""
    from pybullet_multigoal_gym_tpu_torch.ops import dynamics as D
    from pybullet_multigoal_gym_tpu_torch.ops import scene as S
    from pybullet_multigoal_gym_tpu_torch.ops.cuda_multibody import (
        CudaMultiBodyEngine)
    from tests.torch_common import multi_inputs, torch_controls, torch_state
    worst = 0.0
    for task in ('block_rearrange', 'block_stack'):
        for c in captured[task]:
            e = main_path_check('k3_vs_plain', c['scene'],
                                CudaMultiBodyEngine(c['scene']), c, N_FIELDS,
                                task=task, blocks=c['scene'].nb, control='ee')
            if task == 'block_rearrange':
                worst = max(worst, e)
    for nb, control, kind in K3_STRESS:
        sc = D.multibody_consts(S.multi_step_scene(nb),
                                ik_workspace=control == 'ee')
        st, ctl = multi_inputs(nb, kind, N_ENVS)
        stress_check('k3_vs_plain', sc, CudaMultiBodyEngine(sc),
                     torch_state(st, 'cuda'), torch_controls(ctl, 'cuda'),
                     N_FIELDS, blocks=nb, control=control, inputs=kind)
    phase_primitive_k3(captured['primitive'][-1])
    ins_worst = phase_insertion_k3(captured['insertion'])

    timed = [(task, captured[task][-1], 100)
             for task in ('block_rearrange', 'block_stack', 'insertion')]
    timed.append(('primitive_push_assemble', captured['primitive'][-1],
                  PRIM_SUBSTEPS))
    res = {task: k3_timing(kernels, count_lib, task, c, n_sub)
           for task, c, n_sub in timed}
    res['block_rearrange']['max_abs_err'] = worst
    res['insertion']['max_abs_err'] = ins_worst
    return res


def k3_timing(kernels, count_lib, task, c, n_sub):
    """K3 timed on a main path's own inputs ``c``: the kernel alone on
    inputs packed once (``ms``), the wrapper's whole call (``call_ms``),
    the plain version, and the bound from the operations counted on the
    same inputs (tests/kernel_ops.py); the instance's registers, stack and
    spills. Returns the figures."""
    import torch
    from pybullet_multigoal_gym_tpu_torch.ops import multibody_plain as MP
    from pybullet_multigoal_gym_tpu_torch.ops.cuda_multibody import (
        CudaMultiBodyEngine, library, n_rows, pack, scene_key)
    from tests.kernel_ops import multibody_ops
    sc, st, ctl = c['scene'], c['phys'], c['controls']
    w = CudaMultiBodyEngine(sc)
    n = st.q.shape[0]
    rows, ctl_rows = pack(st, ctl)
    out = torch.empty_like(rows)
    ms = time_ms(lambda: w.launch(rows, ctl_rows, out, n_sub), 10)
    call_ms = time_ms(lambda: w.control_step(st, ctl, n_sub), 10)
    plain_ms = time_ms(lambda: MP.control_step(sc, st, ctl, n_sub), 1)
    ops, _ = multibody_ops(count_lib, sc, st, ctl, n_sub)
    b_ms, b_by = bound_ms(n * (2 * n_rows(sc.nb) + 11) * 4, ops)
    res = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, ops=ops)
    mangled = mangled_scene(scene_key(sc))
    emit('k3_timing', task=task, bodies=sc.nb, geoms=sc.ng,
         inputs=main_path_name(c), substeps=n_sub, envs=n,
         lanes=len(MP.lane_plan(sc)),
         launches_per_env_step=PRIM_LAUNCHES if 'sub_target' in c else 1,
         **res, ptxas=[p for p in kernels[library(sc)].ptxas
                       if mangled in p['function']])
    return res


def mangled_scene(key):
    """The template arguments of a K3 instance as they appear in its
    mangled name (ptxas reports per entry function)."""
    return ('ILi%dELi%dELi%dELj%dELi%dELy%dELi%dELi%dELi%dELj%dELi%dELi%dEE'
            % key)


def phase_primitive_k3(c):
    """K3 on the primitive's main path ``c`` and its 'press' stress state.
    After 2 substeps every env of the main path lies within 1e-4 or its
    noise bound (`main_path_check`). After 80 free substeps the slot, which
    rocks on the plate, parts hundreds of envs of the plain version's own
    noisy runs, and the kernel's run can land beyond their bound in an env
    or two; so the 80 substeps are held one at a time, each from the plain
    trajectory's state, every env within 1e-4 (`forced_check`), and the
    free run's reading is printed beside it (`free_reading`)."""
    from pybullet_multigoal_gym_tpu_torch.ops.cuda_multibody import (
        CudaMultiBodyEngine)
    from tests.torch_common import (primitive_inputs, torch_controls,
                                    torch_state)
    sc, tag = c['scene'], dict(task='primitive_push_assemble', control='ee')
    w = CudaMultiBodyEngine(sc)
    main_path_check('k3_vs_plain', sc, w, c, N_FIELDS, substeps=PRIM_FLAT[:1],
                    **tag)
    forced_check('k3_vs_plain', sc, w, c, N_FIELDS, PRIM_SUBSTEPS, **tag)
    free_reading('k3_free_run_reading', sc, w, c, N_FIELDS, *PRIM_FLAT[1],
                 **tag)
    st, ctl = primitive_inputs(('slot', 'cube'), 'press', PRIM_ENVS)
    stress_check('k3_vs_plain', sc, w, torch_state(st, 'cuda'),
                 torch_controls(ctl, 'cuda'), N_FIELDS, substeps=PRIM_FLAT,
                 inputs='press', **tag)


# the lane groups a pinned body brings, each to act in the insertion stress
# states (the edge lanes of the box-pinned group named apart)
PINNED_GROUPS = ('box-pinned', 'box-pinned edge', 'finger-pinned',
                 'sphere-pinned')


def phase_insertion_k3(captured):
    """K3 on insertion's main path (steps 1 and 26 of a seeded drive at
    1024 envs, `main_path_check`) and its stress states
    (tests/torch_common.py:insertion_inputs: 'load', the rectangle on the
    slot's mouth between the squeezing pads, which rest on the prongs;
    'slot_pressed', the rectangle driven into the slot's base bar and a
    wrist sphere on its end bar; `stress_check`), where each group of
    PINNED_GROUPS must act in some envs: their largest shares are
    printed."""
    from pybullet_multigoal_gym_tpu_torch.ops import dynamics as D
    from pybullet_multigoal_gym_tpu_torch.ops import scene as S
    from pybullet_multigoal_gym_tpu_torch.ops.cuda_multibody import (
        CudaMultiBodyEngine)
    from tests.torch_common import (insertion_inputs, torch_controls,
                                    torch_state)
    tag = dict(task='insertion', control='ee')
    sc = D.multibody_consts(S.insertion_scene())
    w = CudaMultiBodyEngine(sc)
    worst = max(main_path_check('k3_vs_plain', sc, w, c, N_FIELDS, **tag)
                for c in captured)
    shares = {}
    for kind in ('load', 'slot_pressed'):
        st, ctl = insertion_inputs(kind, INS_ENVS)
        shares[kind] = stress_check(
            'k3_vs_plain', sc, w, torch_state(st, 'cuda'),
            torch_controls(ctl, 'cuda'), N_FIELDS, inputs=kind, **tag)
    acting = {g: {k: v.get(g, 0.0) for k, v in shares.items()}
              for g in PINNED_GROUPS}
    emit('k3_pinned_lanes_active', **tag, envs=INS_ENVS,
         share_of_envs=acting)
    idle = [g for g, v in acting.items() if not max(v.values()) > 0]
    if idle:
        raise AssertionError('no insertion stress state activates the '
                             'lane groups %s: %s' % (idle, acting))
    return worst


def phase_chest_k3(torch, port, kernels, count_lib):
    """K3 on chest_push's main path with 4 blocks (steps 1 and 26 of a
    seeded drive at 1024 envs, `main_path_check`, the door's state among
    the fields held; `k3_timing` on step 26's inputs) and on the chest's
    stress states with 2 blocks
    (tests/torch_common.py:chest_inputs: the blocks dropped beside and
    inside the open chest, the pads sweeping the door's handle, a block
    pressed against the closed door, the door's motor holding it at its
    stop while the arm leans on a wall, the reset pose; `stress_check`),
    for both doors, where each group of CHEST_GROUPS must act in some env:
    their largest shares are printed. Returns the timing's figures, with
    the main path's largest error."""
    from pybullet_multigoal_gym_tpu_torch.ops import dynamics as D
    from pybullet_multigoal_gym_tpu_torch.ops import scene as S
    from pybullet_multigoal_gym_tpu_torch.ops.cuda_multibody import (
        CudaMultiBodyEngine)
    from tests.torch_common import (CHEST_DOOR, chest_inputs, torch_controls,
                                    torch_state)
    captured = main_path_inputs(torch, port, 'chest_push',
                                num_envs=CHEST_ENVS, num_block=4)
    sc = captured[0]['scene']
    w = CudaMultiBodyEngine(sc)
    worst = max(main_path_check('k3_vs_plain', sc, w, c, CHEST_FIELDS,
                                task='chest_push', blocks=sc.nb, control='ee')
                for c in captured)
    res = k3_timing(kernels, count_lib, 'chest_push', captured[-1], 100)
    shares = {}
    for task, kind, substeps in CHEST_STRESS:
        sc2 = D.multibody_consts(S.multi_step_scene(2, True, CHEST_DOOR[task]))
        st, ctl = chest_inputs(CHEST_DOOR[task], 2, kind, CHEST_ENVS)
        shares[task, kind] = stress_check(
            'k3_vs_plain', sc2, CudaMultiBodyEngine(sc2),
            torch_state(st, 'cuda'), torch_controls(ctl, 'cuda'),
            CHEST_FIELDS, substeps=substeps, task=task, blocks=2,
            control='ee', inputs=kind)
    acting = {g: {'%s %s' % k: v[g] for k, v in shares.items()
                  if v.get(g, 0.0) > 0} for g in CHEST_GROUPS}
    emit('k3_chest_lanes_active', envs=CHEST_ENVS, blocks=2,
         share_of_envs=acting)
    idle = [g for g, v in acting.items() if not v]
    if idle:
        raise AssertionError('no chest stress state activates the lane '
                             'groups %s: %s' % (idle, shares))
    return dict(res, max_abs_err=worst)


def phase_chest_largest(torch, port, kernels):
    """The largest plan of the suite once: chest_pick_and_place with 5
    blocks under joint control (every arm-sphere lane kept), one step at
    1024 envs through `make_vec_env`, with the device memory free before
    and after (the card reserves the kernel's per-thread stack for every
    thread it can hold at its first launch); then K3 on that step's inputs
    against its plain version on 64 envs after 2 substeps
    (`main_path_check`)."""
    from pybullet_multigoal_gym_tpu_torch.ops import multibody_plain as MP
    from pybullet_multigoal_gym_tpu_torch.ops.cuda_multibody import (
        CudaMultiBodyEngine, library, scene_key)
    torch.cuda.synchronize()
    free_before = torch.cuda.mem_get_info()
    c = main_path_inputs(torch, port, 'chest_pick_and_place', at=(0,),
                         seed=3, num_envs=CHEST_ENVS, num_block=5,
                         joint_control=True)[0]
    torch.cuda.synchronize()
    free_after = torch.cuda.mem_get_info()
    sc = c['scene']
    emit('chest_largest_plan', task='chest_pick_and_place', blocks=sc.nb,
         control='joint', envs=CHEST_ENVS, lanes=len(MP.lane_plan(sc)),
         mem_free_before=free_before[0], mem_free_after=free_after[0],
         mem_total=free_before[1],
         ptxas=[p for p in kernels[library(sc)].ptxas
                if mangled_scene(scene_key(sc)) in p['function']])
    few = dict(c, phys=type(c['phys'])(*(x[:64] for x in c['phys'])),
               controls=type(c['controls'])(*(x[:64] for x in
                                               c['controls'])))
    main_path_check('k3_vs_plain', sc, CudaMultiBodyEngine(sc), few,
                    CHEST_FIELDS, substeps=FLAT[:1],
                    task='chest_pick_and_place', blocks=sc.nb,
                    control='joint', largest_plan=True)


def phase_chest_main(torch, port):
    """The chest main paths: chest_push with 4 blocks at 1024 envs for 60
    steps (auto-reset at step 50), then its first 64 envs stepped once on
    the card and on the CPU from one state (`chest_plain_check`), then
    chest_push with 2 blocks for 60 steps and chest_pick_and_place with 1
    for 5."""
    want = dict(ik=CHEST_STEPS, engine=CHEST_STEPS)
    out = {}
    for nb, seed in ((4, 0), (2, 1)):
        env, state, res = drive(torch, port, 'chest_push', CHEST_STEPS,
                                seed=seed, num_envs=CHEST_ENVS,
                                timed_from=CHEST_TIMED_FROM, num_block=nb)
        emit('chest_push_path', card=card_line(), **res)
        dims = {'observation': (CHEST_ENVS, 28 + 16 * nb),
                'policy_state': (CHEST_ENVS, 23 + 3 * nb),
                'achieved_goal': (CHEST_ENVS, 1 + 3 * nb),
                'desired_goal': (CHEST_ENVS, 1 + 3 * nb)}
        if not (res['obs_finite'] and res['shapes_ok']
                and res['obs_shapes'] == dims
                and res['done_steps'] == [50] and res['all_done_steps'] == [50]
                and res['launches'] == want):
            raise AssertionError('chest_push path check failed: %s' % res)
        if nb == 4:
            chest_plain_check(torch, port, state, 'chest_push', num_block=nb)
        out[nb] = res
    _, _, pick = drive(torch, port, 'chest_pick_and_place', 5, seed=2,
                       num_envs=CHEST_ENVS, timed_from=1, num_block=1)
    emit('chest_pick_and_place_path', card=card_line(), **pick)
    if not (pick['obs_finite'] and pick['shapes_ok']
            and pick['launches'] == dict(ik=5, engine=5)):
        raise AssertionError('chest_pick_and_place path check failed: %s'
                             % pick)
    return out


def chest_plain_check(torch, port, state, task, envs=64, tol=5e-3, **kw):
    """The kernels' path against the plain path over one chest step: the
    first ``envs`` envs of ``state`` stepped once on the card and on the CPU
    from one state, with the door 5 mm from its open state in every other
    env (the hold-open latch sets in the step) and the latch already set in
    every fourth (the door's motor drives it open). The observation (the
    door's q and qd and its keypoints among it) within ``tol``; the latch
    equal wherever the door lies ``tol`` or more from the latch's
    threshold."""
    import numpy as np
    from pybullet_multigoal_gym_tpu_torch import interop
    leaves = {k: v[:envs] for k, v in interop.state_to_numpy(state).items()}
    opened = np.float32(port.EnvConfig(task=task).chest_door_opened_state)
    i = np.arange(envs)
    leaves['.phys.door_q'] = np.where(i % 2 == 0, opened - np.float32(0.005),
                                      leaves['.phys.door_q'])
    leaves['.door_hold_open'] = leaves['.door_hold_open'] | (i % 4 == 1)
    g = torch.Generator().manual_seed(5)
    out = {}
    for dev in ('cuda', 'cpu'):
        e = port.make_vec_env(num_envs=envs, task=task, device=dev, **kw)
        if dev == 'cuda':
            action = actions(torch, e, g, (envs,))
        s = interop.state_from_numpy(leaves, device=dev)
        s, o, _, _, _ = e.step(s, action.to(dev))
        out[dev] = dict(obs=o['observation'].cpu(),
                        latch=s.door_hold_open.cpu(),
                        door_q=s.phys.door_q.cpu())
    err = (out['cuda']['obs'] - out['cpu']['obs']).abs().max(1).values
    sure = ((opened - out['cpu']['door_q']).abs() - 0.01).abs() >= tol
    differ = (out['cuda']['latch'] != out['cpu']['latch']) & sure
    res = dict(task=task, **kw, envs=envs, steps=1,
               compared='the observation (the door among it) and the '
                        'hold-open latch', tol=tol,
               max_abs_err_obs=float(err.max()),
               envs_beyond_tol=int((err > tol).sum()),
               latched=int(out['cpu']['latch'].sum()),
               latch_compared=int(sure.sum()), latch_differ=int(differ.sum()))
    emit('chest_vs_plain', **res)
    if not (float(err.max()) <= tol and not differ.any()
            and res['latched'] > 0):
        raise AssertionError('%s: the kernel path disagrees with the plain '
                             'path: %s' % (task, res))


def phase_door_drive(torch, port):
    """The door-opening drive: phases 0-3 of tests/policies.py:
    ChestPushExpert for every env at once (rise, go above the handle, descend
    to it, sweep +y; tests/torch_common.py:door_opening_action) through
    `make_vec_env(task='chest_push', num_block=4)` at 1024 envs on the
    kernels, until every env has ended its sweep or for DOOR_DRIVE_STEPS
    steps (the TimeLimit beyond them). At least one env latches its door
    open; in every latched env the door then stays at 0.11 or above under
    the hold-open motor for the rest of the drive; the observations stay
    finite and the blocks slower than 1 m/s (the bar of the JAX package's
    `test_block_trapped_against_door_stalls`)."""
    from tests.torch_common import door_opening_action
    env = port.make_vec_env(num_envs=CHEST_ENVS, task='chest_push',
                            num_block=4, seed=4,
                            max_episode_steps=DOOR_DRIVE_STEPS + 1)
    state, obs = env.reset()
    core = env.core
    core.ik.launches = core.engine.launches = 0
    phase = torch.zeros(CHEST_ENVS, dtype=torch.long, device='cuda')
    latched = torch.zeros(CHEST_ENVS, dtype=torch.bool, device='cuda')
    low = torch.full((CHEST_ENVS,), float('inf'), device='cuda')
    finite = torch.ones((), dtype=torch.bool, device='cuda')
    speed = torch.zeros((), device='cuda')
    for step in range(DOOR_DRIVE_STEPS):
        a, phase = door_opening_action(obs, phase)
        state, obs, _, _, _ = env.step(state, a)
        # the door's value in each env latched before this step
        low = torch.where(latched, torch.minimum(low, state.phys.door_q), low)
        latched = state.door_hold_open
        for v in obs_leaves(obs).values():
            finite &= torch.isfinite(v).all()
        speed = torch.maximum(speed, torch.linalg.vector_norm(
            state.phys.body_linvel, dim=-1).max())
        if bool((phase >= 4).all()):
            break
    res = dict(task='chest_push', blocks=4, envs=CHEST_ENVS, steps=step + 1,
               share_swept=float((phase >= 4).float().mean()),
               share_latched=float(latched.float().mean()),
               min_door_q_after_latch=float(low.min()),
               max_block_speed=float(speed), obs_finite=bool(finite),
               launches=dict(ik=core.ik.launches, engine=core.engine.launches))
    emit('chest_door_drive', **res)
    if not (latched.any() and res['min_door_q_after_latch'] >= 0.11
            and res['obs_finite'] and res['max_block_speed'] < 1.0
            and res['launches'] == dict(ik=step + 1, engine=step + 1)):
        raise AssertionError('door-opening drive failed: %s' % res)


def phase_multi_main(torch, port):
    """The multi-step main paths: block_rearrange with 2 blocks at 4096 envs
    for 60 steps (auto-reset at step 50), the same 64 envs stepped once on
    the card and on the CPU from one state, then block_stack with 5 blocks
    at 1024 envs for STACK_STEPS steps."""
    env, state, res = drive(torch, port, 'block_rearrange', MAIN_STEPS,
                            seed=0, num_block=2)
    emit('block_rearrange_path', card=card_line(), **res)
    want = dict(ik=MAIN_STEPS, engine=MAIN_STEPS)
    if not (res['obs_finite'] and res['shapes_ok']
            and res['done_steps'] == [50] and res['all_done_steps'] == [50]
            and res['launches'] == want):
        raise AssertionError('block_rearrange path check failed: %s' % res)
    err = plain_path_check(torch, port, 'block_rearrange', state, env,
                           num_block=2)
    emit('block_rearrange_vs_plain', task='block_rearrange', blocks=2,
         envs=64, steps=1, max_abs_err_obs=err, tol=5e-3)
    if not err <= 5e-3:
        raise AssertionError('block_rearrange: the kernel path disagrees '
                             'with the plain path: %g' % err)
    _, _, stack = drive(torch, port, 'block_stack', STACK_STEPS, seed=1,
                        num_envs=STACK_ENVS, timed_from=STACK_TIMED_FROM,
                        num_block=5)
    emit('block_stack_path', card=card_line(), **stack)
    if not (stack['obs_finite'] and stack['shapes_ok']
            and stack['launches'] == dict(ik=STACK_STEPS, engine=STACK_STEPS)):
        raise AssertionError('block_stack path check failed: %s' % stack)
    return res, stack


def drive(torch, port, task, steps, seed, num_envs=N_ENVS,
          timed_from=TIMED_FROM, **kw):
    """``steps`` env steps of seeded actions through the public entry point,
    timed from step ``timed_from`` on; the kernel launch counts are zeroed
    just before and read just after."""
    env = port.make_vec_env(num_envs=num_envs, task=task, seed=seed, **kw)
    state, obs = env.reset()
    g = torch.Generator(device='cuda').manual_seed(seed)
    acts = actions(torch, env, g, (steps, num_envs))
    dims = {k: tuple(v.shape) for k, v in obs_leaves(obs).items()}
    done_at = []
    finite = torch.ones((), dtype=torch.bool, device='cuda')
    core = env.core
    core.ik.launches = core.engine.launches = 0
    per_step = {'ik': set(), 'engine': set()}
    torch.cuda.synchronize()
    t0 = None
    for i in range(steps):
        if i == timed_from:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        before = core.ik.launches, core.engine.launches
        state, obs, reward, done, info = env.step(state, acts[i])
        per_step['ik'].add(core.ik.launches - before[0])
        per_step['engine'].add(core.engine.launches - before[1])
        done_at.append(done)
        for v in obs_leaves(obs).values():
            finite &= torch.isfinite(v).all()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0 if t0 is not None else None
    launches = dict(ik=core.ik.launches, engine=core.engine.launches)
    done_steps = [i + 1 for i, d in enumerate(done_at) if bool(d.any())]
    all_done = [i + 1 for i, d in enumerate(done_at) if bool(d.all())]
    shapes_ok = {k: tuple(v.shape)
                 for k, v in obs_leaves(obs).items()} == dims
    rate = (steps - timed_from) * num_envs / elapsed if elapsed else None
    return env, state, dict(task=task, **kw, envs=num_envs, steps=steps,
                            timed_steps=[timed_from + 1, steps] if elapsed
                            else None,
                            launches=launches,
                            launches_per_step={k: sorted(v) for k, v in
                                               per_step.items()},
                            done_steps=done_steps,
                            all_done_steps=all_done, obs_finite=bool(finite),
                            obs_shapes=dims, shapes_ok=shapes_ok,
                            env_steps_per_s=rate)


def obs_leaves(obs):
    """An observation's tensors by name, one level of dicts flattened
    (insertion's ``subtask_rewards`` as 'subtask_rewards.pick_up', ...)."""
    out = {}
    for k, v in obs.items():
        if isinstance(v, dict):
            out.update(('%s.%s' % (k, kk), vv) for kk, vv in v.items())
        else:
            out[k] = v
    return out


def plain_path_check(torch, port, task, state, env, copies=0, **kw):
    """The kernels' path against the plain path: the first 64 envs of
    ``state`` stepped once on the card and on the CPU; observations within
    5e-3. With ``copies``, returns instead each env's error and each of
    that many copies' errors against the CPU's step, the copies stepped on
    the CPU with 1-ulp noise in every substep
    (tests/torch_common.py:NoisyEngine): (N,) and (copies, N)."""
    import numpy as np
    from pybullet_multigoal_gym_tpu_torch import interop
    from tests.torch_common import NoisyEngine
    leaves = {k: v[:64] for k, v in interop.state_to_numpy(state).items()}
    g = torch.Generator().manual_seed(5)
    action = actions(torch, env, g, (64,))
    obs = {}
    for dev, k in (('cuda', 1), ('cpu', 1), ('noisy', copies)):
        if not k:
            continue
        e = port.make_vec_env(num_envs=64 * k, task=task,
                              device='cuda' if dev == 'cuda' else 'cpu', **kw)
        if dev == 'noisy':
            e.core.engine = NoisyEngine(e.core.scene)
        s = interop.state_from_numpy(
            {key: np.concatenate([v] * k) for key, v in leaves.items()},
            device=e.device)
        _, o, _, _, _ = e.step(s, torch.cat([action] * k).to(e.device))
        obs[dev] = o['observation'].cpu()
    err = (obs['cuda'] - obs['cpu']).abs()
    if not copies:
        return float(err.max())
    errs = (obs['noisy'].reshape(copies, 64, -1) - obs['cpu']).abs()
    return err.amax(1), errs.amax(2)


def phase_primitive_main(torch, port):
    """The push-primitive main paths: primitive_push_assemble with
    discrete_push at 1024 envs for PRIM_STEPS steps, timed after the first
    PRIM_TIMED_FROM, with exactly 20 K1 and 20 K3 launches in every step;
    its first 16 envs stepped once on the card and on the CPU from one state
    (1600 plain substeps, `primitive_plain_check`); primitive_push_reach
    with continuous_push for 4 steps."""
    want = dict(ik=[PRIM_LAUNCHES], engine=[PRIM_LAUNCHES])
    env, state, res = drive(torch, port, 'primitive_push_assemble',
                            PRIM_STEPS, seed=0, num_envs=PRIM_ENVS,
                            timed_from=PRIM_TIMED_FROM,
                            primitive='discrete_push')
    emit('primitive_path', card=card_line(), **res)
    if not (res['obs_finite'] and res['shapes_ok']
            and res['launches_per_step'] == want and not res['done_steps']):
        raise AssertionError('primitive path check failed: %s' % res)
    primitive_plain_check(torch, port, state)
    _, _, reach = drive(torch, port, 'primitive_push_reach', 4, seed=1,
                        num_envs=PRIM_ENVS, timed_from=1,
                        primitive='continuous_push')
    emit('primitive_reach_path', card=card_line(), **reach)
    if not (reach['obs_finite'] and reach['shapes_ok']
            and reach['launches_per_step'] == want):
        raise AssertionError('primitive_push_reach path check failed: %s'
                             % reach)
    return res


def as_quat(torch, poses):
    """Poses (N, 6k: positions and ZYZ Euler angles, as the primitive's
    observation and goal hold them), each Euler triplet replaced by its
    rotation (a unit quaternion, w >= 0): the triplet is singular for a
    flat object (beta 0), where alpha and gamma are each arbitrary and only
    their sum is defined, so a last-bit tilt turns them by up to 2 pi."""
    from pybullet_multigoal_gym_tpu_torch.maths import quat as Q
    o = poses.reshape(poses.shape[0], -1, 6)
    q = Q.euler_zyz_to_quat(o[..., 3:])
    q = torch.where(q[..., :1] < 0, -q, q)
    return torch.cat([o[..., :3], q], -1).flatten(1)


def primitive_plain_check(torch, port, state, envs=16, tol=5e-3):
    """The kernels' path against the plain path over one primitive step:
    the first ``envs`` envs of ``state`` stepped once on the card and on the
    CPU from one state. The object poses (the observation), the goal the
    step regenerates (desired_goal), both with rotations as quaternions
    (`as_quat`), and the reward: every env within ``tol``."""
    from pybullet_multigoal_gym_tpu_torch import interop
    leaves = {k: v[:envs] for k, v in interop.state_to_numpy(state).items()}
    g = torch.Generator().manual_seed(5)
    out = {}
    for dev in ('cuda', 'cpu'):
        e = port.make_vec_env(num_envs=envs, task='primitive_push_assemble',
                              primitive='discrete_push', device=dev)
        if dev == 'cuda':
            action = actions(torch, e, g, (envs,))
        s = interop.state_from_numpy(leaves, device=dev)
        _, o, reward, _, _ = e.step(s, action.to(dev))
        out[dev] = dict(observation=as_quat(torch, o['observation']).cpu(),
                        desired_goal=as_quat(torch, o['desired_goal']).cpu(),
                        reward=reward[:, None].cpu())
    err = {k: (v - out['cpu'][k]).abs().max(1).values
           for k, v in out['cuda'].items()}
    worst = max(float(v.max()) for v in err.values())
    res = dict(task='primitive_push_assemble', envs=envs, steps=1,
               compared='object poses and desired_goal with rotations as '
                        'quaternions, and the reward', tol=tol,
               max_abs_err={k: float(v.max()) for k, v in err.items()},
               envs_beyond_tol=int((torch.stack(list(err.values())) > tol)
                                   .any(0).sum()))
    emit('primitive_vs_plain', **res)
    if not worst <= tol:
        raise AssertionError('primitive_push_assemble: the kernel path '
                             'disagrees with the plain path: %s' % res)


# the JAX package's insertion observation, per env: (N,) + these
INS_OBS_DIMS = {
    'observation': (24,), 'policy_state': (17,),
    'auxiliary_task_state': (12,), 'achieved_goal': (6,),
    'desired_goal': (6,), 'subtask_rewards.pick_up': (),
    'subtask_rewards.pick_up_done': (),
    'subtask_rewards.pick_up_desired_goal': (4,),
    'subtask_rewards.pick_up_achieved_goal': (4,),
    'subtask_rewards.reach': (), 'subtask_rewards.reach_done': (),
    'subtask_rewards.reach_desired_goal': (6,),
    'subtask_rewards.reach_achieved_goal': (6,),
    'subtask_rewards.insert': (), 'subtask_rewards.insert_done': (),
    'subtask_rewards.insert_desired_goal': (6,),
    'subtask_rewards.insert_achieved_goal': (6,)}


def phase_insertion_main(torch, port):
    """insertion at 1024 envs for INS_STEPS steps (auto-reset at step 50),
    timed after the first INS_TIMED_FROM, with exactly one K1 and one K3
    launch per step and the JAX package's observation shapes; then its
    first 64 envs stepped once on the card and on the CPU from one state
    (`insertion_plain_check`)."""
    env, state, res = drive(torch, port, 'insertion', INS_STEPS, seed=0,
                            num_envs=INS_ENVS, timed_from=INS_TIMED_FROM)
    emit('insertion_path', card=card_line(), **res)
    want = dict(ik=INS_STEPS, engine=INS_STEPS)
    dims = {k: (INS_ENVS,) + d for k, d in INS_OBS_DIMS.items()}
    if not (res['obs_finite'] and res['shapes_ok']
            and res['obs_shapes'] == dims
            and res['done_steps'] == [50] and res['all_done_steps'] == [50]
            and res['launches'] == want):
        raise AssertionError('insertion path check failed: %s' % res)
    insertion_plain_check(torch, port, state)
    return res


def insertion_plain_check(torch, port, state, envs=64, tol=5e-3,
                          away=0.01):
    """The kernels' path against the plain path over one insertion step:
    the first ``envs`` envs of ``state`` stepped once on the card and on
    the CPU from one state. The physics state (positions, velocities,
    rotations as unit quaternions with w >= 0) and the EE impulse (force x
    dt): every env within ``tol``. The reward and the subtask done flags:
    equal in every env whose goal distance lies ``tol`` or more from the
    threshold and, for those that hold the rectangle's ZYZ Euler angles
    (the reward, reach and insert), whose rectangle is ``away`` from the
    angles' singularity in both paths (sin(beta / 2) >= ``away``: an
    upright rectangle has beta 0, where alpha and gamma are each set by
    the last bits of its tilt); the counts compared are printed."""
    from pybullet_multigoal_gym_tpu_torch import interop
    from pybullet_multigoal_gym_tpu_torch.ops import dynamics as D
    leaves = {k: v[:envs] for k, v in interop.state_to_numpy(state).items()}
    g = torch.Generator().manual_seed(5)
    out = {}
    for dev in ('cuda', 'cpu'):
        e = port.make_vec_env(num_envs=envs, task='insertion', device=dev)
        if dev == 'cuda':
            action = actions(torch, e, g, (envs,))
        s = interop.state_from_numpy(leaves, device=dev)
        s, o, reward, _, _ = e.step(s, action.to(dev))
        ph = s.phys
        quat = torch.where(ph.body_quat[..., :1] < 0, -ph.body_quat,
                           ph.body_quat)
        sub = o['subtask_rewards']
        out[dev] = dict(
            state=torch.cat([ph.q, ph.qd, ph.fq, ph.fqd,
                             ph.body_pos.flatten(1), quat.flatten(1),
                             ph.body_linvel.flatten(1),
                             ph.body_angvel.flatten(1),
                             ph.ee_contact_force * D.DT_SUB], -1).cpu(),
            tilt=torch.linalg.vector_norm(quat[:, 0, 1:3], dim=-1).cpu(),
            dist=torch.stack([torch.linalg.vector_norm(
                o['achieved_goal'] - o['desired_goal'], dim=-1),
                -sub['pick_up'], -sub['reach'], -sub['insert']], -1).cpu(),
            flags=torch.stack([reward < 0, sub['pick_up_done'],
                               sub['reach_done'], sub['insert_done']],
                              -1).cpu())
    err = (out['cuda']['state'] - out['cpu']['state']).abs().max(1).values
    sure = (out['cpu']['dist'] - e.cfg.distance_threshold).abs() >= tol
    away_ok = torch.minimum(out['cuda']['tilt'], out['cpu']['tilt']) >= away
    # pick_up holds no Euler angle; the reward, reach and insert do
    compared = sure & torch.stack([away_ok, torch.ones_like(away_ok),
                                   away_ok, away_ok], -1)
    differ = (out['cuda']['flags'] != out['cpu']['flags']) & compared
    names = ('reward', 'pick_up_done', 'reach_done', 'insert_done')
    res = dict(task='insertion', envs=envs, steps=1,
               compared='the physics state with rotations as quaternions '
                        'and the EE impulse; the reward and the subtask '
                        'done flags', tol=tol,
               max_abs_err=float(err.max()),
               envs_beyond_tol=int((err > tol).sum()),
               envs_away_from_singularity=int(away_ok.sum()),
               flags_compared=dict(zip(names, compared.sum(0).tolist())),
               flags_differ=dict(zip(names, differ.sum(0).tolist())))
    emit('insertion_vs_plain', **res)
    if not (float(err.max()) <= tol and not differ.any()):
        raise AssertionError('insertion: the kernel path disagrees with the '
                             'plain path: %s' % res)


SLIDE_GROUPS = ('cyl-plane', 'finger-cyl lateral', 'finger-cyl vertical',
                'sphere-box')


def phase_slide_k2(kernels, captured, count_lib):
    """K2's cylinder instances (slide) against ops/engine_plain.py on the
    card.

    - slide's main path's own inputs, steps 1 and 26 of a seeded drive at
      4096 envs. Under EE control (the main path), `main_path_check`. Under
      joint control (every arm-sphere lane) the free run of 100 substeps is
      chaotic: in one env of each capture the plain version's own noisy
      runs part by 3 and 6.5. So, as on the primitive's main path: every
      env after 2 substeps (`main_path_check`), the 100 substeps one at a
      time from the plain trajectory's state, every env-substep within 1e-4
      (`forced_check`), and the free run printed (`free_reading`).
    - slide's stress states (tests/torch_common.py:slide_inputs, the CPU
      tests' states at 4096 envs), `stress_check` (K2's rule: each env
      within its own bound) after 2 substeps, and after 100 too for the
      drop, the tilted puck, the coast and the sphere. In 'strike' and
      'cap' the pads ram the puck into the table and the free run forks
      on the last bit (PERF.md, PR 8: tests/k2_fork_witness.py), so their
      100 substeps are held one at a time as the joint-control main
      path's are (`forced_check`, `free_reading`). Each of the cylinder's
      lane groups acts in the state made for it: the rim points ('tilt'),
      the pads' lateral ('strike') and vertical ('cap') lanes, and an arm
      sphere on the puck ('sphere').

    Timed on the main path's inputs at step 26 (EE control), as push is
    (`phase_engine`). Returns slide's figures: ``max_abs_err`` over the
    main path's checks under EE control; under joint control the largest
    error of its gated checks (2 substeps, and the forced substeps),
    ``max_abs_err_joint``, and of its free run, ``..._free_run``."""
    import torch
    from pybullet_multigoal_gym_tpu_torch.ops import engine_plain as EP
    from pybullet_multigoal_gym_tpu_torch.ops.cuda_engine import (CudaEngine,
                                                                  pack)
    from tests.kernel_ops import engine_ops
    from tests.torch_common import (SLIDE_KINDS, slide_inputs,
                                    torch_controls, torch_state)
    engines, worst = {}, {'ee': 0.0, 'joint': 0.0, 'free': 0.0}
    for control in ('ee', 'joint'):
        cs = captured['slide' if control == 'ee' else 'slide_joint']
        sc = cs[0]['scene']
        w = CudaEngine(sc)
        engines[control] = sc, w
        tag = dict(task='slide', control=control)
        for c in cs:
            if control == 'ee':
                worst['ee'] = max(worst['ee'], main_path_check(
                    'k2_vs_plain', sc, w, c, N_FIELDS, **tag))
                continue
            gated, free = chaotic_check('k2_vs_plain', sc, w, c, N_FIELDS,
                                        **tag)
            worst['joint'] = max(worst['joint'], gated)
            worst['free'] = max(worst['free'], free)
    shares = {}
    for kind in SLIDE_KINDS:
        control = 'joint' if kind == 'sphere' else 'ee'
        sc, w = engines[control]
        st, ctl = slide_inputs(kind, N_ENVS)
        c = dict(phys=torch_state(st, 'cuda'),
                 controls=torch_controls(ctl, 'cuda'), inputs=kind)
        tag = dict(task='slide', control=control)
        rams = kind in ('strike', 'cap')
        shares[kind] = stress_check(
            'k2_vs_plain', sc, w, c['phys'], c['controls'], N_FIELDS,
            substeps=FLAT[:1] if rams else FLAT, inputs=kind, **tag)
        if rams:
            forced_check('k2_vs_plain', sc, w, c, N_FIELDS, 100, **tag)
            free_reading('k2_free_run_reading', sc, w, c, N_FIELDS,
                         *FLAT[1], **tag)
    made_for = dict(zip(('tilt', 'strike', 'cap', 'sphere'), SLIDE_GROUPS))
    acts = {g: shares[k][g] for k, g in made_for.items()}
    emit('k2_slide_lanes_active', shares=acts)
    if not all(v > 0 for v in acts.values()):
        raise AssertionError('a cylinder lane group acts in no env of the '
                             'state made for it: %s' % acts)

    sc, w = engines['ee']
    c = captured['slide'][-1]
    st, ctl = c['phys'], c['controls']
    rows, ctl_rows = pack(st, ctl)
    out = torch.empty_like(rows)
    ms = time_ms(lambda: w.launch(rows, ctl_rows, out, 100), 10)
    call_ms = time_ms(lambda: w.control_step(st, ctl), 10)
    plain_ms = time_ms(lambda: EP.control_step(sc, st, ctl, 100), 1)
    ops, _ = engine_ops(count_lib, sc, st, ctl, 100)
    b_ms, b_by = bound_ms(N_ENVS * (34 + 9 + 34) * 4, ops)
    res = dict(max_abs_err=worst['ee'], max_abs_err_joint=worst['joint'],
               max_abs_err_joint_free_run=worst['free'], ms=ms,
               call_ms=call_ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, ops=ops)
    # the slide instances: engine_kernel<0, 2, ...> (csrc/engine.cu: the
    # parallel jaw, BODY_CYL)
    emit('k2_timing', task='slide', inputs='main path, step %d' % c['step'],
         substeps=100, envs=N_ENVS, **res,
         ptxas=[p for p in kernels['engine'].ptxas
                if 'engine_kernelILi0ELi2E' in p['function']])
    return res


def phase_slide_main(torch, port, k2_call_ms):
    """slide@4096 for 60 steps (auto-reset at step 50), timed over steps
    11-60 as push is, with exactly one K1 and one K2 launch per step, and
    K2's share of the step (the step-26 call against the timed step); then
    its first 64 envs stepped once on the card and on the CPU from one
    state (`plain_path_check`)."""
    env, state, res = drive(torch, port, 'slide', MAIN_STEPS, seed=0)
    emit('slide_path', card=card_line(), **res)
    want = dict(ik=MAIN_STEPS, engine=MAIN_STEPS)
    if not (res['obs_finite'] and res['shapes_ok']
            and res['done_steps'] == [50] and res['all_done_steps'] == [50]
            and res['launches'] == want):
        raise AssertionError('slide path check failed: %s' % res)
    step_ms = 1e3 * N_ENVS / res['env_steps_per_s']
    emit('slide_step_breakdown', task='slide', envs=N_ENVS, step_ms=step_ms,
         k2_call_ms=k2_call_ms, k2_share=k2_call_ms / step_ms,
         card=card_line())
    err = plain_path_check(torch, port, 'slide', state, env)
    emit('slide_vs_plain', task='slide', envs=64, steps=1,
         max_abs_err_obs=err, tol=5e-3)
    if not err <= 5e-3:
        raise AssertionError('slide: the kernel path disagrees with the '
                             'plain path: %g' % err)
    return res


def phase_slide_strike(torch, port):
    """The scripted strike (tests/policies.py:SlideExpert, the expert of
    the JAX package's `test_slide_scripted`) through `make_env(task=
    'slide', joint_control=True, max_episode_steps=150)` on the card, one
    env, for STRIKE_EPISODES episodes; its IK is the port's plain
    `ops/ik.solve`. K2 runs at 1 env here (one block of 32 threads, 31
    masked): first held against its plain version on the first step's
    inputs after 2 substeps (`main_path_check`). Gate: in every step the
    puck is finite, above STRIKE_FLOOR_Z and under 0.25 m, and within 2.0 m
    of the origin in xy (not launched); at the end of each episode it lies
    on the table (0.16 < z < 0.25), as `test_slide_scripted` holds the JAX
    package. Each episode's lowest height, the steps under 0.16 m and the
    goal distances at the start and the end are printed; the distances
    are not held."""
    import contextlib
    import numpy as np
    from pybullet_multigoal_gym_tpu_torch.ops import dynamics as D
    from pybullet_multigoal_gym_tpu_torch.ops import ik
    from tests.policies import SlideExpert
    with contextlib.redirect_stdout(sys.stderr):    # make_env's id line
        env = port.make_env(task='slide', joint_control=True,
                            max_episode_steps=STRIKE_STEPS, seed=0)
    core = env.venv.core
    rest = torch.as_tensor(core.rest_pose)

    ik_calls = [0, 0.0]     # the expert's IK solves and their seconds

    def ik_solve(p, qi):
        t0 = time.perf_counter()
        q = ik.solve(torch.as_tensor(p, dtype=torch.float32),
                     q_init=torch.as_tensor(qi, dtype=torch.float32),
                     rest_pose=rest).numpy()
        ik_calls[0] += 1
        ik_calls[1] += time.perf_counter() - t0
        return q

    expert = SlideExpert(ik_solve, core.rest_pose)
    core.engine.launches = 0
    init_d, final_d, steps, achieved, end_z = [], [], [], [], []
    off_table, low_steps, lowest, farthest = False, 0, [], 0.0
    for ep in range(STRIKE_EPISODES):
        obs = env.reset()
        expert.reset()
        init_d.append(float(np.linalg.norm(obs['achieved_goal'][:2]
                                           - obs['desired_goal'][:2])))
        lowest.append(np.inf)
        for k in range(STRIKE_STEPS):
            action = expert(obs)
            if ep == 0 and k == 0:
                st, f_target = core.step_decode_pre(
                    env._state, torch.as_tensor(action, device='cuda')[None])
                zero = st.phys.door_q
                c = dict(step=1, phys=st.phys, controls=D.Controls(
                    q_target=core.arm_targets(st), f_target=f_target,
                    door_motor_on=zero > 0, door_target=zero))
                main_path_check('k2_vs_plain', core.scene, core.engine, c,
                                N_FIELDS, substeps=FLAT[:1], task='slide',
                                control='joint', envs_in_batch=1)
                core.engine.launches = 0
            obs, reward, done, info = env.step(action)
            puck = obs['achieved_goal']
            off_table = off_table or not bool(
                np.isfinite(puck).all() and STRIKE_FLOOR_Z < puck[2] < 0.25
                and np.linalg.norm(puck[:2]) < 2.0)
            low_steps += int(puck[2] <= 0.16)
            lowest[-1] = min(lowest[-1], float(puck[2]))
            farthest = max(farthest, float(np.linalg.norm(puck[:2])))
            if info['goal_achieved']:
                break
        steps.append(k + 1)
        achieved.append(info['goal_achieved'])
        end_z.append(float(puck[2]))
        final_d.append(float(np.linalg.norm(puck[:2]
                                            - obs['desired_goal'][:2])))
    on_table = all(0.16 < z < 0.25 for z in end_z)
    res = dict(episodes=STRIKE_EPISODES, steps=steps,
               launches=core.engine.launches, ik_solves=ik_calls[0],
               ik_seconds=ik_calls[1], floor_z=STRIKE_FLOOR_Z,
               puck_left_the_table=off_table, puck_z_at_episode_end=end_z,
               puck_on_table_at_end=on_table, puck_lowest_z=lowest,
               steps_with_puck_under_016=low_steps,
               puck_max_xy_norm=farthest, initial_goal_distance=init_d,
               final_goal_distance=final_d, goal_achieved=achieved)
    emit('slide_strike', card=card_line(), **res)
    if off_table or not on_table or res['launches'] != sum(steps):
        raise AssertionError('slide strike check failed: %s' % res)
    return res


ROBOTIQ = 'robotiq85'
# the Robotiq-85's lane groups, each to act in the stress state made for it
# (tests/torch_common.py:robotiq_inputs)
ROBOTIQ_K2_MADE_FOR = {'grasp': 'finger-box', 'pad_table': 'finger-plane',
                       'sphere': 'sphere-plane'}
ROBOTIQ_K3_MADE_FOR = {'grasp': 'finger-box', 'pile': 'box-box',
                       'sphere': 'sphere-plane'}
# robotiq_grasp: copies of the JAX package's grasp-and-lift
# (tests/test_robotiq.py:95-127), and the blocks' jitter of its second run
GRASP_ENVS, GRASP_JITTER = 1024, 0.005


def robotiq_captures(torch, port):
    """What K1, K2 and K3 are given on the Robotiq-85's main paths
    (main_path_inputs, steps 1 and 26 at 4096 envs): push and
    block_rearrange with 2 blocks under EE control, and push under joint
    control (K2 only)."""
    return dict(
        robotiq_push=main_path_inputs(torch, port, 'push', gripper=ROBOTIQ),
        robotiq_push_joint=main_path_inputs(torch, port, 'push',
                                            joint_control=True,
                                            gripper=ROBOTIQ),
        robotiq_block_rearrange=main_path_inputs(
            torch, port, 'block_rearrange', num_block=2, gripper=ROBOTIQ))


def phase_robotiq_ik(captured, count_lib):
    """K1 toward the Robotiq-85's tip (0.18 m out along link 7's z) on its
    main paths' own inputs, push and block_rearrange at steps 1 and 26,
    8 iterations, against ops/ik.py:solve within 1e-4; timed on push's
    step 26 as `phase_ik` times the jaw's. Returns the figures."""
    import torch
    from pybullet_multigoal_gym_tpu_torch.ops import ik
    from pybullet_multigoal_gym_tpu_torch.ops.cuda_ik import CudaIK, pack
    from tests.kernel_ops import ik_ops
    w = CudaIK(num_iters=8, gripper=ROBOTIQ)
    worst = 0.0
    for task in ('push', 'block_rearrange'):
        for c in captured['robotiq_' + task]:
            tg, q, r = c['target'], c['q_init'], c['rest']
            err = float((w.solve(tg, q_init=q, rest_pose=r)
                         - ik.solve(tg, q_init=q, rest_pose=r, num_iters=8,
                                    gripper=ROBOTIQ)).abs().max())
            emit('k1_vs_plain', inputs='%s main path, step %d' % (
                task, c['step']), gripper=ROBOTIQ, iters=8, envs=N_ENVS,
                tol=1e-4, max_abs_err=err)
            if not err <= 1e-4:
                raise AssertionError('K1 with the Robotiq tip (%s, step %d) '
                                     'disagrees with its plain version: %g'
                                     % (task, c['step'], err))
            worst = max(worst, err)
    c = captured['robotiq_push'][-1]
    tg, q, r = c['target'], c['q_init'], c['rest']
    packed = pack(tg, rest_pose=r, q_init=q)
    out = torch.empty((7, N_ENVS), device='cuda')
    ops, _ = ik_ops(count_lib, tg, q_init=q, rest_pose=r, num_iters=8,
                    gripper=ROBOTIQ)
    b_ms, b_by = bound_ms(N_ENVS * (21 + 7) * 4, ops)
    res = dict(max_abs_err=worst, ms=time_ms(lambda: w.launch(packed, out),
                                             50),
               call_ms=time_ms(lambda: w.solve(tg, q_init=q, rest_pose=r),
                               50),
               plain_ms=time_ms(lambda: ik.solve(tg, q_init=q, rest_pose=r,
                                                 num_iters=8,
                                                 gripper=ROBOTIQ), 3),
               bound_ms=b_ms, bound_by=b_by, ops=ops)
    emit('k1_timing', inputs='push main path, step %d' % c['step'],
         gripper=ROBOTIQ, iters=8, envs=N_ENVS, **res)
    return res


def phase_robotiq_k2(kernels, captured, count_lib):
    """K2's Robotiq-85 instances against ops/engine_plain.py on the card.

    - push's main path under EE control at 4096 envs: step 26 by
      `main_path_check` (flat bounds; an env beyond them held to its noise
      bound, none beyond that). The reset puts the Robotiq's pads 3.5 cm
      inside the table, and in the first step the table throws the arm up
      with impulses of thousands of newtons: the plain version's own noisy
      runs part by more than 2e-3 in a third of the envs, by up to 13. So
      step 1, and the main path under joint control (every arm-sphere
      lane) at steps 1 and 26, go through `chaotic_check`: every env after
      2 substeps, every env-substep of the 100 within 1e-4 from the plain
      trajectory's state, the free run printed.
    - the Robotiq stress states (tests/torch_common.py:robotiq_inputs):
      the pads closing on a block, both fingers driven into their stops,
      the short pads pressed on the table, a wrist sphere on the table
      (joint control); `stress_check` (K2's rule) after 2 and 100
      substeps. Each lane group of ROBOTIQ_K2_MADE_FOR acts in its state.

    Timed on the EE main path's step 26 as push is (`phase_engine`).
    Returns the figures: the largest error of the EE main path's gated
    checks, of the joint control's, and of the free runs beside the forced
    ones."""
    import torch
    from pybullet_multigoal_gym_tpu_torch.ops import engine_plain as EP
    from pybullet_multigoal_gym_tpu_torch.ops.cuda_engine import (CudaEngine,
                                                                  pack)
    from tests.kernel_ops import engine_ops
    from tests.torch_common import (ROBOTIQ_KINDS, robotiq_inputs,
                                    torch_controls, torch_state)
    engines, worst = {}, {'ee': 0.0, 'joint': 0.0, 'free': 0.0}
    for control in ('ee', 'joint'):
        cs = captured['robotiq_push' + ('_joint' if control == 'joint'
                                        else '')]
        sc = cs[0]['scene']
        w = CudaEngine(sc)
        engines[control] = sc, w
        tag = dict(task='push', gripper=ROBOTIQ, control=control)
        for c in cs:
            if control == 'ee' and c['step'] > 1:
                worst['ee'] = max(worst['ee'], main_path_check(
                    'k2_vs_plain', sc, w, c, N_FIELDS, **tag))
                continue
            gated, free = chaotic_check('k2_vs_plain', sc, w, c, N_FIELDS,
                                        **tag)
            worst[control] = max(worst[control], gated)
            worst['free'] = max(worst['free'], free)
    shares = {}
    for kind in ROBOTIQ_KINDS:
        control = 'joint' if kind == 'sphere' else 'ee'
        sc, w = engines[control]
        st, ctl = robotiq_inputs(kind, N_ENVS)
        shares[kind] = stress_check(
            'k2_vs_plain', sc, w, torch_state(st, 'cuda'),
            torch_controls(ctl, 'cuda'), N_FIELDS, task='push',
            gripper=ROBOTIQ, control=control, inputs=kind)
    acts = {k: shares[k].get(g, 0.0) for k, g in ROBOTIQ_K2_MADE_FOR.items()}
    emit('k2_robotiq_lanes_active', shares=acts, made_for=ROBOTIQ_K2_MADE_FOR)
    if not all(v > 0 for v in acts.values()):
        raise AssertionError('a Robotiq lane group acts in no env of the '
                             'state made for it: %s' % acts)

    sc, w = engines['ee']
    c = captured['robotiq_push'][-1]
    st, ctl = c['phys'], c['controls']
    rows, ctl_rows = pack(st, ctl)
    out = torch.empty_like(rows)
    ops, _ = engine_ops(count_lib, sc, st, ctl, 100)
    b_ms, b_by = bound_ms(N_ENVS * (34 + 9 + 34) * 4, ops)
    res = dict(max_abs_err=worst['ee'], max_abs_err_joint=worst['joint'],
               max_abs_err_free_run=worst['free'],
               ms=time_ms(lambda: w.launch(rows, ctl_rows, out, 100), 10),
               call_ms=time_ms(lambda: w.control_step(st, ctl), 10),
               plain_ms=time_ms(lambda: EP.control_step(sc, st, ctl, 100), 1),
               bound_ms=b_ms, bound_by=b_by, ops=ops)
    # the Robotiq push instance: engine_kernel<1, 1, ...> (csrc/engine.cu)
    emit('k2_timing', task='push', gripper=ROBOTIQ,
         inputs='main path, step %d' % c['step'], substeps=100, envs=N_ENVS,
         **res, ptxas=[p for p in kernels['engine'].ptxas
                       if 'engine_kernelILi1ELi1E' in p['function']])
    return res


def phase_robotiq_k3(kernels, captured, count_lib):
    """K3's Robotiq-85 instances against ops/multibody_plain.py on the card:
    block_rearrange's main path with 2 blocks at 4096 envs (step 26 by
    `main_path_check`; step 1, where the table throws out the pads that
    the reset put inside it, by `chaotic_check`, as K2's), and the Robotiq
    stress states with 2 blocks (the
    pads closing on a block, a pile of two whose top block they squeeze,
    a wrist sphere on the table under joint control; `stress_check`, K3's
    rule), each lane group of ROBOTIQ_K3_MADE_FOR acting in its state;
    timed on step 26 (`k3_timing`). Returns the figures."""
    from pybullet_multigoal_gym_tpu_torch.ops import dynamics as D
    from pybullet_multigoal_gym_tpu_torch.ops import scene as S
    from pybullet_multigoal_gym_tpu_torch.ops.cuda_multibody import (
        CudaMultiBodyEngine)
    from tests.torch_common import (robotiq_inputs, torch_controls,
                                    torch_state)
    cs = captured['robotiq_block_rearrange']
    sc = cs[0]['scene']
    tag = dict(task='block_rearrange', gripper=ROBOTIQ, blocks=2)
    w = CudaMultiBodyEngine(sc)
    worst = free = 0.0
    for c in cs:
        if c['step'] > 1:
            worst = max(worst, main_path_check('k3_vs_plain', sc, w, c,
                                               N_FIELDS, control='ee', **tag))
            continue
        gated, f = chaotic_check('k3_vs_plain', sc, w, c, N_FIELDS,
                                 control='ee', **tag)
        worst, free = max(worst, gated), max(free, f)
    shares = {}
    for kind in ROBOTIQ_K3_MADE_FOR:
        control = 'joint' if kind == 'sphere' else 'ee'
        sc2 = D.multibody_consts(S.multi_step_scene(2),
                                 ik_workspace=control == 'ee',
                                 gripper=ROBOTIQ)
        st, ctl = robotiq_inputs(kind, N_ENVS, nb=2)
        shares[kind] = stress_check(
            'k3_vs_plain', sc2, CudaMultiBodyEngine(sc2),
            torch_state(st, 'cuda'), torch_controls(ctl, 'cuda'), N_FIELDS,
            control=control, inputs=kind, **tag)
    acts = {k: shares[k].get(g, 0.0) for k, g in ROBOTIQ_K3_MADE_FOR.items()}
    emit('k3_robotiq_lanes_active', shares=acts, made_for=ROBOTIQ_K3_MADE_FOR)
    if not all(v > 0 for v in acts.values()):
        raise AssertionError('a Robotiq lane group acts in no env of the '
                             'state made for it: %s' % acts)
    res = k3_timing(kernels, count_lib, 'block_rearrange', cs[-1], 100)
    return dict(res, max_abs_err=worst, max_abs_err_free_run=free)


def phase_robotiq_main(torch, port, k2_call_ms, k3_call_ms):
    """The Robotiq-85's main paths: push and block_rearrange with 2 blocks
    at 4096 envs for 60 steps (auto-reset at step 50), timed over steps
    11-60, with exactly one K1 and one K2 or K3 launch per step and `done`
    at step 50 only; the kernel's share of the step; then 64 envs of each
    stepped once on the card and on the CPU from one state
    (`plain_path_check`): the pads press on the table in much of a drive
    (the EE target may sit on the table, the pads 2-5 cm below the tip),
    and one step from one state forks on the last bit in some envs. So
    each env is held to 5e-3, or where the plain path's own N_NOISE copies
    with 1-ulp noise in every substep part by more, to SPREAD_FACTOR times
    their spread; for K3 (block_rearrange) as many envs beyond that,
    and as far, as a noisy copy lies beyond the others' bound, as
    `stress_check` allows K3 in block piles. Returns each drive's
    figures."""
    from tests.torch_common import spread_bound
    res = {}
    for task, kw, k_ms in (('push', {}, k2_call_ms),
                           ('block_rearrange', dict(num_block=2),
                            k3_call_ms)):
        env, state, r = drive(torch, port, task, MAIN_STEPS, seed=0,
                              gripper=ROBOTIQ, **kw)
        emit('robotiq_%s_path' % task, card=card_line(), **r)
        want = dict(ik=MAIN_STEPS, engine=MAIN_STEPS)
        if not (r['obs_finite'] and r['shapes_ok']
                and r['done_steps'] == [50] and r['all_done_steps'] == [50]
                and r['launches'] == want
                and r['launches_per_step'] == dict(ik=[1], engine=[1])):
            raise AssertionError('Robotiq %s path check failed: %s'
                                 % (task, r))
        step_ms = 1e3 * N_ENVS / r['env_steps_per_s']
        emit('robotiq_step_breakdown', task=task, gripper=ROBOTIQ,
             envs=N_ENVS, step_ms=step_ms, kernel_call_ms=k_ms,
             kernel_share=k_ms / step_ms, card=card_line())
        err, errs = plain_path_check(torch, port, task, state, env,
                                     copies=N_NOISE, gripper=ROBOTIQ,
                                     **kw)
        bound, spread, allowed, cap = spread_bound(errs, 5e-3, SPREAD_FACTOR)
        if task == 'push':      # K2's rule: no env beyond its bound
            allowed, cap = 0, 1.0
        share = err / bound
        beyond = torch.nonzero(share > 1).flatten()
        emit('robotiq_%s_vs_plain' % task, task=task, gripper=ROBOTIQ,
             envs=64, steps=1, max_abs_err_obs=float(err.max()), tol=5e-3,
             envs_beyond_tol=int((err > 5e-3).sum()),
             plain_noise_envs_beyond_tol=int((spread > 5e-3).sum()),
             plain_noise_max_spread=float(spread.max()),
             envs_beyond_allowed=allowed, share_allowed=cap,
             max_share_of_env_bound=float(share.max()),
             envs_beyond_env_bound=int(beyond.numel()))
        if beyond.numel() > allowed or share.max() > cap:
            raise AssertionError(
                'Robotiq %s: the kernel path disagrees with the plain path '
                'in envs %s: %s against %s (%d envs and a share of %g '
                'allowed)' % (task, beyond.tolist(), err[beyond].tolist(),
                              bound[beyond].tolist(), allowed, cap))
        res[task] = r
    return res


def phase_robotiq_grasp(torch, port):
    """The JAX package's `test_robotiq_grasps_and_lifts_block` on the card,
    through the push env's K2 wrapper at GRASP_ENVS copies of its state:
    the tip 35 mm above a block on the table, the pads open, closed toward
    0.804 for 2 control steps (every env's pads stall on the block at
    0.5-0.62 rad), then the arm's target 6 cm higher for 3 (every block
    above 0.21 m). Then the same with each block moved by up to
    GRASP_JITTER in x and y: the share of envs that hold both is printed,
    not held."""
    from pybullet_multigoal_gym_tpu_torch.model import kuka_model as KM
    from pybullet_multigoal_gym_tpu_torch.ops import dynamics as D
    from pybullet_multigoal_gym_tpu_torch.ops import ik
    env = port.make_vec_env(num_envs=GRASP_ENVS, task='push', gripper=ROBOTIQ)
    eng = env.core.engine
    q_init = torch.tensor(KM.KUKA_REST_POSE, dtype=torch.float32)
    q0 = ik.solve(torch.tensor([-0.52, 0.0, 0.175 + 0.035]), q_init=q_init,
                  gripper=ROBOTIQ)
    q_up = ik.solve(torch.tensor([-0.52, 0.0, 0.175 + 0.095]), q_init=q0,
                    gripper=ROBOTIQ)
    g = torch.Generator(device='cuda').manual_seed(3)
    out = {}
    for name, jitter in (('exact', 0.0), ('jittered', GRASP_JITTER)):
        bp = torch.tensor([-0.52, 0.0, 0.175], device='cuda').expand(
            GRASP_ENVS, 1, 3).clone()
        bp[..., :2] += jitter * (2 * torch.rand((GRASP_ENVS, 1, 2),
                                                generator=g,
                                                device='cuda') - 1)
        st = D.init_state(GRASP_ENVS, q=q0.cuda(), body_pos=bp, fq=0.0,
                          device='cuda')
        ctl = D.Controls(
            q_target=q0.cuda().expand(GRASP_ENVS, 7),
            f_target=torch.full((GRASP_ENVS, 2), 0.804, device='cuda'),
            door_motor_on=torch.zeros(GRASP_ENVS, dtype=torch.bool,
                                      device='cuda'),
            door_target=torch.zeros(GRASP_ENVS, device='cuda'))
        eng.launches = 0
        for _ in range(2):
            st = eng.control_step(st, ctl)
        fq = st.fq[:, 0]
        stalled = (fq > 0.5) & (fq < 0.62)
        ctl = ctl._replace(q_target=q_up.cuda().expand(GRASP_ENVS, 7))
        for _ in range(3):
            st = eng.control_step(st, ctl)
        z = st.body_pos[:, 0, 2]
        lifted = (z > 0.21) & torch.isfinite(st.body_pos).all(-1).all(-1)
        out[name] = dict(
            stalled_share=float(stalled.float().mean()),
            lifted_share=float(lifted.float().mean()),
            held_share=float((stalled & lifted).float().mean()),
            fq_range=[float(fq.min()), float(fq.max())],
            z_range=[float(z.min()), float(z.max())],
            launches=eng.launches)
    emit('robotiq_grasp', envs=GRASP_ENVS, jitter=GRASP_JITTER,
         card=card_line(), **out)
    exact = out['exact']
    if not (exact['held_share'] == 1.0 and exact['launches'] == 5):
        raise AssertionError('the Robotiq grasp-and-lift failed on the card: '
                             '%s' % out)
    return out


def phase_main(torch, port):
    """The main path: push@4096 for 60 steps (auto-reset at step 50), then
    the same 64 envs stepped once on the card and on the CPU from one state,
    then reach@4096 for 5 steps."""
    card = card_line()
    env, state, res = drive(torch, port, 'push', MAIN_STEPS, seed=0)
    emit('main_path', card=card, **res)
    want = dict(ik=MAIN_STEPS, engine=MAIN_STEPS)
    if not (res['obs_finite'] and res['shapes_ok']
            and res['done_steps'] == [50] and res['all_done_steps'] == [50]
            and res['launches'] == want):
        raise AssertionError('main path check failed: %s' % res)

    # the kernels' path against the plain path on a small input
    err = plain_path_check(torch, port, 'push', state, env)
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
    counting = kernel_ops.build(_build.BUILD_DIR / 'count', start_only=True)
    kernels = _build.build_all()
    count_lib = kernel_ops.load(counting)
    emit('build', kernels={k: dict(source=str(v.path.name), ptxas=v.ptxas)
                  for k, v in kernels.items()})

    captured = {task: main_path_inputs(torch, port, task)
                for task in ('push', 'reach')}
    captured['block_rearrange'] = main_path_inputs(
        torch, port, 'block_rearrange', num_block=2)
    captured['block_stack'] = main_path_inputs(
        torch, port, 'block_stack', at=(25,), num_envs=STACK_ENVS,
        num_block=5)
    captured['primitive'] = primitive_main_inputs(torch, port)
    captured['insertion'] = main_path_inputs(torch, port, 'insertion',
                                             num_envs=INS_ENVS)
    captured['slide'] = main_path_inputs(torch, port, 'slide')
    # K1 does not run under joint control: K2's checks only
    slide_joint = main_path_inputs(torch, port, 'slide', joint_control=True)
    captured.update(robotiq_captures(torch, port))
    ik_res = phase_ik(captured, count_lib)
    eng_res = phase_engine(kernels, captured, count_lib)
    main_res = phase_main(torch, port)
    mb_res = phase_multibody(kernels, captured, count_lib)
    multi_res, _ = phase_multi_main(torch, port)
    phase_primitive_main(torch, port)
    ins_launches = phase_insertion_main(torch, port)['launches']
    slide_k2 = phase_slide_k2(kernels, dict(captured, slide_joint=slide_joint),
                              count_lib)
    slide_res = phase_slide_main(torch, port, slide_k2['call_ms'])
    phase_slide_strike(torch, port)
    # the Robotiq-85's main paths, before the chest's larger stacks
    rq_k1 = phase_robotiq_ik(captured, count_lib)
    rq_k2 = phase_robotiq_k2(kernels, captured, count_lib)
    rq_k3 = phase_robotiq_k3(kernels, captured, count_lib)
    rq_main = phase_robotiq_main(torch, port, rq_k2['call_ms'],
                                 rq_k3['call_ms'])
    phase_robotiq_grasp(torch, port)
    # the chest last: its kernels' larger stacks grow the runtime's
    # per-thread local memory for every later launch
    chest_k3 = phase_chest_k3(torch, port, kernels, count_lib)
    chest_res = phase_chest_main(torch, port)
    phase_chest_largest(torch, port, kernels)
    phase_door_drive(torch, port)
    # K3's share of a chest_push step (4 blocks) at 1024 envs
    step_ms = 1e3 * CHEST_ENVS / chest_res[4]['env_steps_per_s']
    emit('chest_step_breakdown', task='chest_push', blocks=4,
         envs=CHEST_ENVS, step_ms=step_ms,
         k3_call_ms=chest_k3['call_ms'],
         k3_share=chest_k3['call_ms'] / step_ms,
         card=card_line())

    def entry(r, launches):
        """A kernel's figures on a further main path, for its row."""
        return dict(launches=launches, max_abs_err=r['max_abs_err'],
                    ms=r['ms'], plain_ms=r['plain_ms'],
                    bound_ms=r['bound_ms'], bound_by=r['bound_by'],
                    library_ms=None)

    launches = main_res['launches']
    k1, k2, k3 = ik_res, eng_res['push'], mb_res['block_rearrange']
    print(json.dumps({'kernels': [
        dict(name='K1 batched DLS IK (8 iterations)', route='cuda',
             source='pybullet_multigoal_gym_tpu_torch/csrc/ik.cu',
             replaces='pybullet_multigoal_gym_tpu/ops/pallas_ik.py:90',
             launches=launches['ik'], max_abs_err=k1['max_abs_err'],
             ms=k1['ms'], plain_ms=k1['plain_ms'], bound_ms=k1['bound_ms'],
             bound_by=k1['bound_by'], library_ms=None,
             insertion=entry(k1['insertion'], ins_launches['ik']),
             robotiq=entry(rq_k1, rq_main['push']['launches']['ik'])),
        dict(name='K2 fused control step (push, 100 substeps)', route='cuda',
             source='pybullet_multigoal_gym_tpu_torch/csrc/engine.cu',
             replaces='pybullet_multigoal_gym_tpu/ops/pallas_engine.py:497',
             launches=launches['engine'],
             # over the main path's inputs (the stress states are held
             # to each env's own bound: see k2_vs_plain)
             max_abs_err=max(r['max_abs_err'] for r in eng_res.values()),
             ms=k2['ms'], plain_ms=k2['plain_ms'], bound_ms=k2['bound_ms'],
             bound_by=k2['bound_by'], library_ms=None,
             slide=dict(entry(slide_k2, slide_res['launches']['engine']),
                        max_abs_err_joint=slide_k2['max_abs_err_joint'],
                        max_abs_err_joint_free_run=slide_k2[
                            'max_abs_err_joint_free_run']),
             robotiq=dict(entry(rq_k2,
                                rq_main['push']['launches']['engine']),
                          max_abs_err_joint=rq_k2['max_abs_err_joint'],
                          max_abs_err_free_run=rq_k2[
                              'max_abs_err_free_run'])),
        dict(name='K3 fused multi-body control step (block_rearrange, 2 '
                  'blocks, 100 substeps)', route='cuda',
             source='pybullet_multigoal_gym_tpu_torch/csrc/multibody.cu',
             replaces='pybullet_multigoal_gym_tpu/ops/pallas_multibody.py:259',
             launches=multi_res['launches']['engine'],
             # over block_rearrange's main-path inputs (the stress states
             # are held to each env's own bound: see k3_vs_plain)
             max_abs_err=k3['max_abs_err'], ms=k3['ms'],
             plain_ms=k3['plain_ms'], bound_ms=k3['bound_ms'],
             bound_by=k3['bound_by'], library_ms=None,
             insertion=entry(mb_res['insertion'], ins_launches['engine']),
             robotiq=dict(entry(rq_k3, rq_main['block_rearrange'][
                 'launches']['engine']),
                 max_abs_err_free_run=rq_k3['max_abs_err_free_run']),
             chest=entry(chest_k3, chest_res[4]['launches']['engine'])),
    ]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
