"""Kernel K2: the fused control step on the card (`csrc/engine.cu`).

Replaces `pybullet_multigoal_gym_tpu/ops/pallas_engine.py:_build_kernel`
(launched through `PallasEngine.control_step`) for the no-object scene, the
one-free-box scene and the one-free-cylinder scene (slide), with the
parallel-jaw gripper or the Robotiq-85. Its plain version is
`ops/engine_plain.py:control_step`:
the wrapper runs that for tensors on the CPU and launches the kernel for
tensors on a CUDA device, and raises for any other device.

One launch runs all ``n_substeps`` substeps with the state held on chip: the
state is read once and written once, as (34, N) SoA rows in the order of
`pallas_engine.py:40-47` (q 7, qd 7, fq 2, fqd 2, body pos 3, quat 4, linvel
3, angvel 3, EE force 3), and the controls as (9, N) rows (q target 7,
finger target 2). The scene's static constants go in a small parameter
vector; which lanes exist is a template of the kernel, picked by the scene
(`scene_key`).
"""

import torch

from pybullet_multigoal_gym_tpu_torch.ops import _build, engine_plain
from pybullet_multigoal_gym_tpu_torch.ops import dynamics as D
from pybullet_multigoal_gym_tpu_torch.ops import scene as S
from pybullet_multigoal_gym_tpu_torch.ops.cuda_ik import (check_operand,
                                                         check_rows)

# the kernels' gripper template integer (kin.cuh GRIP_JAW, GRIP_ROBOTIQ)
GRIPPERS = ('parallel_jaw', 'robotiq85')


def scene_key(sc: D.SceneConsts):
    """The kernel instance a scene runs on (an `ENGINE_SCENES` entry of
    `engine.cu`): its gripper (0 the parallel jaw, 1 the Robotiq-85), its
    body (0 none, 1 a box, 2 a cylinder), and the arm spheres that keep a
    plane lane and a body lane (bit masks)."""
    body = 0 if not sc.has_body else (1 if sc.geom_type == S.BOX else 2)
    return GRIPPERS.index(sc.gripper), body, sc.plane_mask, sc.geom_mask


def scene_params(sc: D.SceneConsts):
    """The kernel's parameter vector, in the order of `engine.cu`'s
    ``P_*`` enum (a cylinder's radius is ``half[0]``, its half length
    ``half[2]``)."""
    return [sc.plane_z, sc.plane_friction, sc.plane_mu, sc.finger_mu,
            sc.body_friction, sc.half[0], sc.half[1], sc.half[2],
            sc.inv_mass, sc.inv_inertia[0], sc.inv_inertia[1],
            sc.inv_inertia[2], sc.erp / D.DT_SUB, sc.slop]


def pack(state: D.PhysicsState, controls: D.Controls):
    """The kernel's inputs: (34, N) state rows and (9, N) control rows.
    Raises unless every field is a float32 (N, k) tensor on one device."""
    device, n = state.q.device, state.q.shape[0]
    rows = (state.q, state.qd, state.fq, state.fqd, state.body_pos[:, 0],
            state.body_quat[:, 0], state.body_linvel[:, 0],
            state.body_angvel[:, 0], state.ee_contact_force)
    names = ('q', 'qd', 'fq', 'fqd', 'body_pos', 'body_quat', 'body_linvel',
             'body_angvel', 'ee_contact_force')
    for x, name, k in zip(rows, names, (7, 7, 2, 2, 3, 4, 3, 3, 3)):
        check_operand(x, name, n, k, device)
    check_operand(controls.q_target, 'q_target', n, 7, device)
    check_operand(controls.f_target, 'f_target', n, 2, device)
    return (torch.cat(rows, 1).t().contiguous(),
            torch.cat([controls.q_target, controls.f_target], 1).t().contiguous())


def unpack(out, state: D.PhysicsState) -> D.PhysicsState:
    """The state after the step from the kernel's (34, N) output rows (the
    door, which these scenes lack, passes through)."""
    flat = out.t()
    return D.PhysicsState(
        q=flat[:, 0:7], qd=flat[:, 7:14], fq=flat[:, 14:16],
        fqd=flat[:, 16:18], body_pos=flat[:, None, 18:21],
        body_quat=flat[:, None, 21:25], body_linvel=flat[:, None, 25:28],
        body_angvel=flat[:, None, 28:31], door_q=state.door_q,
        door_qd=state.door_qd, ee_contact_force=flat[:, 31:34])


class CudaEngine:
    """Batched control step for one single-step scene.

    ``launches`` counts the kernel's launches (CPU calls are not counted)."""

    def __init__(self, sc: D.SceneConsts):
        self.sc = sc
        self.launches = 0
        self._params = {}

    def control_step(self, state: D.PhysicsState, controls: D.Controls,
                     n_substeps: int = D.SIM_CALLS_PER_STEP * D.SUBSTEPS_PER_SIM
                     ) -> D.PhysicsState:
        device = state.q.device
        if device.type == 'cpu':
            return engine_plain.control_step(self.sc, state, controls,
                                             n_substeps)
        if device.type != 'cuda':
            raise ValueError('CudaEngine runs on cuda (kernel) or cpu (plain '
                             'version), not %s' % device)
        st, ctl = pack(state, controls)
        out = torch.empty_like(st)
        self.launch(st, ctl, out, n_substeps)
        return unpack(out, state)

    def launch(self, st, ctl, out, n_substeps):
        """One launch on the current stream: `pack`'s (34, N) state and
        (9, N) control rows in, the (34, N) state after ``n_substeps`` into
        ``out``."""
        n, device = st.shape[-1], st.device
        for x, name, k in ((st, 'st', 34), (ctl, 'ctl', 9), (out, 'out', 34)):
            check_rows(x, name, k, n, device)
        prm = self._params.get(device)
        if prm is None:
            prm = torch.tensor(scene_params(self.sc), dtype=torch.float32,
                               device=device)
            self._params[device] = prm
        kern = _build.load('engine')
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            rc = kern.fn(*scene_key(self.sc), st.data_ptr(), ctl.data_ptr(),
                         prm.data_ptr(), out.data_ptr(), n, int(n_substeps),
                         self.sc.solver_iters, stream)
        _build.check(rc, 'engine')
        self.launches += 1
