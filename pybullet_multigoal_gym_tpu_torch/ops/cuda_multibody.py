"""Kernel K3: the fused control step of multi-body scenes on the card
(`csrc/multibody.cu`).

Replaces `pybullet_multigoal_gym_tpu/ops/pallas_multibody.py:_build_kernel`
(launched through `PallasMultiBodyEngine.control_step`) for scenes of free
and pinned bodies made of box geoms, static boxes and a prismatic door,
with the parallel-jaw gripper: block_stack and block_rearrange with 1-5
blocks, chest_push and chest_pick_and_place with 1-5 blocks, the
push-primitive tasks and insertion; and with the Robotiq-85: block_stack
and block_rearrange. Its plain version is
`ops/multibody_plain.py:control_step`: the wrapper runs that for tensors on
the CPU and launches the kernel for tensors on a CUDA device, and raises for
any other device. `D.multibody_consts` raises for the scenes later slices
bring (the revolving door, cylinders). Each chest task's scenes are a
library of their own (`csrc/chest_push.cu`, `csrc/chest_pick.cu`), the
block scenes with the Robotiq-85 too (`csrc/multibody_robotiq.cu`), the
others' `csrc/multibody.cu`: the four instantiate the template of
`csrc/multibody.cuh` and build at once.

One launch runs all ``n_substeps`` substeps with the state held on chip: the
state is read once and written once, as (18 + 13 NB + 5, N) SoA rows in the
order of `pallas_multibody.py:311-315` (q 7, qd 7, fq 2, fqd 2, per body pos
3, quat 4, linvel 3, angvel 3, door q and qd, EE force 3), and the controls
as (11, N) rows (q target 7, finger target 2, door motor on, door target).
The scene's static constants, the geom table's sizes and offsets among
them, go in a small parameter vector; which lanes exist is a template of
the kernel, picked by the scene's structure (`scene_key`).
"""

import torch

from pybullet_multigoal_gym_tpu_torch.ops import _build, multibody_plain
from pybullet_multigoal_gym_tpu_torch.ops import dynamics as D
from pybullet_multigoal_gym_tpu_torch.ops.cuda_engine import GRIPPERS
from pybullet_multigoal_gym_tpu_torch.ops.cuda_ik import (check_operand,
                                                         check_rows)

N_CTRL = 11


def n_rows(nb):
    return 18 + 13 * nb + 5


def scene_params(sc: D.MultiBodyConsts):
    """The kernel's parameter vector, in the order of `multibody.cuh`'s
    ``P_*``, ``B_*``, ``G_*``, ``S_*`` and ``D_*`` enums."""
    prm = [sc.plane_z, sc.erp / D.DT_SUB, sc.slop, sc.mu_finger_plane,
           sc.mu_sphere_plane]
    for b in range(sc.nb):
        prm += [sc.inv_mass[b]] + list(sc.inv_inertia[b])
        prm += [sc.mu_plane(b), sc.mu_finger(b), sc.mu_sphere(b)]
    prm += [sc.mu_pair(b, b2) for b in range(sc.nb) for b2 in range(sc.nb)]
    for g in range(sc.ng):
        prm += list(sc.geom_half[g]) + list(sc.geom_pos[g])
    for s in range(sc.ns):
        prm += list(sc.static_half[s]) + list(sc.static_pos[s])
        prm += [sc.mu_finger_static(s), sc.mu_sphere_static(s)]
    prm += [sc.mu_static(b, s) for b in range(sc.nb) for s in range(sc.ns)]
    if sc.nd:
        prm += list(sc.door_anchor) + list(sc.door_axis)
        prm += [sc.door_limit, sc.door_inv_mass,
                500.0 * D.DT_SUB * sc.door_inv_mass, 1.0 - 2.0 * D.DT_SUB,
                sc.mu_finger_door, sc.mu_sphere_door]
        prm += [sc.mu_door(b) for b in range(sc.nb)]
        for d in range(sc.nd):
            prm += list(sc.door_half[d]) + list(sc.door_pos[d])
    return prm


def scene_key(sc: D.MultiBodyConsts):
    """The scene's structure as `multibody.cuh` picks its kernel instance
    (an entry of a library's scene list): the gripper (0 the parallel jaw,
    1 the Robotiq-85), bodies, geoms, each geom's body (4 bits a geom), the
    plane mask, each geom's sphere mask (7 bits a geom), the geoms off their
    body's origin (a bit each), the pinned bodies (a bit each), the static
    boxes, each static's sphere mask (7 bits a static), the door's panels (0
    without a door) and their sphere mask."""
    return (GRIPPERS.index(sc.gripper), sc.nb, sc.ng,
            sum(b << 4 * g for g, b in enumerate(sc.geom_body)),
            sc.plane_mask,
            sum(m << 7 * g for g, m in enumerate(sc.geom_mask)),
            sum(1 << g for g, p in enumerate(sc.geom_pos) if any(p)),
            sum(1 << b for b, p in enumerate(sc.pinned) if p),
            sc.ns, sum(m << 7 * s for s, m in enumerate(sc.static_mask)),
            sc.nd, sc.door_mask)


def library(sc: D.MultiBodyConsts):
    """The kernel library that holds the scene's instance: 'multibody'
    without a chest ('multibody_robotiq' with the Robotiq-85), else
    chest_push's (three walls, the front_sliding door the fourth) or
    chest_pick_and_place's (four walls under the lid)."""
    if not (sc.ns or sc.nd):
        return ('multibody_robotiq' if sc.gripper == 'robotiq85'
                else 'multibody')
    return {3: 'chest_push', 4: 'chest_pick'}[sc.ns]


def pack(state: D.PhysicsState, controls: D.Controls):
    """The kernel's inputs: (18 + 13 NB + 5, N) state rows and (11, N)
    control rows. Raises unless every field is a float32 tensor of the
    expected shape on one device."""
    device, n = state.q.device, state.q.shape[0]
    nb = state.body_pos.shape[1]
    rows = [state.q, state.qd, state.fq, state.fqd]
    for b in range(nb):
        rows += [state.body_pos[:, b], state.body_quat[:, b],
                 state.body_linvel[:, b], state.body_angvel[:, b]]
    rows += [state.door_q[:, None], state.door_qd[:, None],
             state.ee_contact_force]
    widths = (7, 7, 2, 2) + (3, 4, 3, 3) * nb + (1, 1, 3)
    for k, (x, w) in enumerate(zip(rows, widths)):
        check_operand(x, 'state row block %d' % k, n, w, device)
    ctl = (controls.q_target, controls.f_target,
           controls.door_motor_on.to(torch.float32)[:, None],
           controls.door_target[:, None])
    for x, name, w in zip(ctl, ('q_target', 'f_target', 'door_motor_on',
                                'door_target'), (7, 2, 1, 1)):
        check_operand(x, name, n, w, device)
    return (torch.cat(rows, 1).t().contiguous(),
            torch.cat(ctl, 1).t().contiguous())


def unpack(out, nb) -> D.PhysicsState:
    """The state after the step from the kernel's (18 + 13 NB + 5, N)
    output rows."""
    flat = out.t()
    n = flat.shape[0]
    body = flat[:, 18:18 + 13 * nb].reshape(n, nb, 13)
    o = 18 + 13 * nb
    return D.PhysicsState(
        q=flat[:, 0:7], qd=flat[:, 7:14], fq=flat[:, 14:16],
        fqd=flat[:, 16:18], body_pos=body[..., 0:3], body_quat=body[..., 3:7],
        body_linvel=body[..., 7:10], body_angvel=body[..., 10:13],
        door_q=flat[:, o], door_qd=flat[:, o + 1],
        ee_contact_force=flat[:, o + 2:o + 5])


class CudaMultiBodyEngine:
    """Batched control step for one multi-body scene.

    ``launches`` counts the kernel's launches (CPU calls are not counted)."""

    def __init__(self, sc: D.MultiBodyConsts):
        self.sc = sc
        self.launches = 0
        self._params = {}

    def control_step(self, state: D.PhysicsState, controls: D.Controls,
                     n_substeps: int = D.SIM_CALLS_PER_STEP * D.SUBSTEPS_PER_SIM
                     ) -> D.PhysicsState:
        device = state.q.device
        if device.type == 'cpu':
            return multibody_plain.control_step(self.sc, state, controls,
                                                n_substeps)
        if device.type != 'cuda':
            raise ValueError('CudaMultiBodyEngine runs on cuda (kernel) or cpu '
                             '(plain version), not %s' % device)
        if state.body_pos.shape[1] != self.sc.nb:
            raise ValueError('the state holds %d bodies, the scene %d'
                             % (state.body_pos.shape[1], self.sc.nb))
        st, ctl = pack(state, controls)
        out = torch.empty_like(st)
        self.launch(st, ctl, out, n_substeps)
        return unpack(out, self.sc.nb)

    def launch(self, st, ctl, out, n_substeps):
        """One launch on the current stream: `pack`'s state and control
        rows in, the state rows after ``n_substeps`` into ``out``."""
        n, device = st.shape[-1], st.device
        rows = n_rows(self.sc.nb)
        for x, name, k in ((st, 'st', rows), (ctl, 'ctl', N_CTRL),
                           (out, 'out', rows)):
            check_rows(x, name, k, n, device)
        prm = self._params.get(device)
        if prm is None:
            prm = torch.tensor(scene_params(self.sc), dtype=torch.float32,
                               device=device)
            self._params[device] = prm
        lib = library(self.sc)
        kern = _build.load(lib)
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            rc = kern.fn(*scene_key(self.sc), st.data_ptr(), ctl.data_ptr(),
                         prm.data_ptr(), out.data_ptr(), n, int(n_substeps),
                         self.sc.solver_iters, stream)
        _build.check(rc, lib)
        self.launches += 1
