"""Physics constants, state and the static scene constants of the engines.

Counterpart of the first part of `pybullet_multigoal_gym_tpu/ops/dynamics.py`
(constants, `PhysicsState`, `Controls`, `Engine.__init__`'s spec constants
and `Engine.init_state`), batched over a leading env axis. The physics itself
is `ops/engine_plain.py` / `ops/multibody_plain.py` (plain PyTorch) and
`ops/cuda_engine.py` / `ops/cuda_multibody.py` (the kernels) for scenes with
at most one free body (a box or an upright cylinder) / several free and
pinned bodies of box geoms, static boxes and a prismatic door. One control step =
``n_substeps`` velocity-level substeps of ``DT_SUB`` seconds (5
stepSimulation calls x 20 substeps = 100).
"""

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from pybullet_multigoal_gym_tpu_torch.model import kuka_model as KM
from pybullet_multigoal_gym_tpu_torch.ops import lane_cull as LC
from pybullet_multigoal_gym_tpu_torch.ops import scene as S
from pybullet_multigoal_gym_tpu_torch.utils.tensors import const

GRAVITY = 9.81
DT_SUB = 0.002                  # base_env.py:74 timestep=0.002
SUBSTEPS_PER_SIM = 20           # frame_skip / numSubSteps (base_env.py:217-219)
SIM_CALLS_PER_STEP = 5          # kuka.py:223-225
ARM_SERVO_RATE = KM.ARM_PD_POSITION_GAIN / DT_SUB     # 15 s^-1
FINGER_VEL_LIMIT = 0.2          # URDF finger joint <limit velocity>
ARM_VEL_LIMIT = 10.0
BIAS_CAP = 0.15                 # max penetration-recovery velocity (m/s)

N_ARM_SPHERES = len(KM.ARM_SPHERE_RADIUS)


class PhysicsState(NamedTuple):
    """Dynamic state of a batch of N environments."""
    q: torch.Tensor            # (N, 7) arm joint positions
    qd: torch.Tensor           # (N, 7)
    fq: torch.Tensor           # (N, 2) finger prismatic positions
    fqd: torch.Tensor          # (N, 2)
    body_pos: torch.Tensor     # (N, NB, 3), NB = max(n_bodies, 1)
    body_quat: torch.Tensor    # (N, NB, 4) wxyz
    body_linvel: torch.Tensor  # (N, NB, 3)
    body_angvel: torch.Tensor  # (N, NB, 3)
    door_q: torch.Tensor       # (N,)
    door_qd: torch.Tensor      # (N,)
    ee_contact_force: torch.Tensor  # (N, 3) world-frame contact force on gripper


class FingerConsts(NamedTuple):
    """A gripper's finger constants (JAX `dynamics.py:178-194`): the pad
    box's half extents in link 7's axes, the finger DoF's inertia (kg for
    the parallel jaw's slide; kg m^2 about the Robotiq-85's closure angle,
    whose pad velocity per unit rate is not a unit vector), its servo's
    force and velocity limit, and its joint range."""
    half: Tuple[float, float, float]
    mass: float
    force: float
    vel_limit: float
    lo: float
    hi: float


def finger_consts(gripper: str) -> FingerConsts:
    """The finger constants of ``gripper`` ('parallel_jaw' or
    'robotiq85')."""
    if gripper == 'robotiq85':
        return FingerConsts(
            half=tuple(float(x) for x in KM.ROBOTIQ_PAD_HALF),
            mass=KM.ROBOTIQ_FINGER_INERTIA, force=KM.ROBOTIQ_PD_FORCE,
            vel_limit=KM.ROBOTIQ_VEL_LIMIT, lo=0.0,
            hi=KM.ROBOTIQ_JOINT_LIMIT)
    return FingerConsts(
        half=tuple(float(x) for x in KM.FINGER_HALF_EXTENTS),
        mass=KM.FINGER_MASS * KM.FINGER_INERTIA_SCALING,
        force=KM.FINGER_PD_FORCE, vel_limit=FINGER_VEL_LIMIT,
        lo=-KM.FINGER_LIMIT, hi=KM.FINGER_LIMIT)


class Controls(NamedTuple):
    q_target: torch.Tensor       # (N, 7)
    f_target: torch.Tensor       # (N, 2) finger joint targets
    door_motor_on: torch.Tensor  # (N,) bool
    door_target: torch.Tensor    # (N,)


@dataclasses.dataclass(frozen=True)
class SceneConsts:
    """Everything static that the control step of a single-free-body scene
    needs, in float32 where the kernels read it."""
    has_body: bool
    # the body's geom: S.BOX, or S.CYLINDER (slide's puck: radius = half[0],
    # half length = half[2]; the arm spheres see it as the box ``half``)
    geom_type: int
    half: Tuple[float, float, float]        # half extents
    inv_mass: float
    inv_inertia: Tuple[float, float, float]  # body-frame diagonal
    body_friction: float
    plane_z: float
    plane_friction: float
    plane_mu: float          # body vs plane
    finger_mu: float         # finger vs body
    # arm-sphere lanes kept by the workspace envelope (lane_cull), bit sp
    plane_mask: int
    geom_mask: int
    # 'parallel_jaw' or 'robotiq85': the pads' kinematics and `finger`
    gripper: str = 'parallel_jaw'
    # solver: 8 mass-splitting Jacobi iterations, Baumgarte erp and slop
    # (the JAX package's Engine defaults)
    solver_iters: int = 8
    erp: float = 0.2
    slop: float = 5e-4

    @property
    def finger(self) -> FingerConsts:
        return finger_consts(self.gripper)


def scene_consts(spec: S.SceneSpec, ik_workspace: bool = True,
                 gripper: str = 'parallel_jaw') -> SceneConsts:
    """Static constants of a single-step scene with ``gripper`` (the
    parallel jaw or the Robotiq-85): the no-object scene, one free box or
    one free upright cylinder (`pallas_engine.py:497-534`).
    ``ik_workspace=False`` (joint control) keeps every arm-sphere lane."""
    assert spec.n_bodies <= 1 and spec.ns_static == 0 and spec.door is None, \
        'single-free-body scenes only'
    has_body = spec.n_bodies == 1
    reach = LC.arm_lane_mask(spec, ik_workspace)
    plane_mask = sum(1 << sp for sp in range(N_ARM_SPHERES)
                     if reach['plane'][sp])
    geom_mask = 0
    half, inv_mass, inv_inertia, fric = (0.0, 0.0, 0.0), 0.0, (0.0,) * 3, 0.0
    geom_type = S.BOX
    if has_body:
        a = spec.np_arrays()
        geom_type = int(a['geom_type'][0])
        half = tuple(float(x) for x in a['geom_half'][0])
        mass = float(a['body_mass'][0])
        inv_mass = 1.0 / mass
        fric = float(a['body_friction'][0])
        inertia = S.body_inertia_diag(mass, half, geom_type)
        inv_inertia = tuple(float(x) for x in (1.0 / inertia).astype(np.float32))
        geom_mask = sum(1 << sp for sp in range(N_ARM_SPHERES)
                        if reach['geom'][sp][0])
    return SceneConsts(
        has_body=has_body, geom_type=geom_type, half=half, inv_mass=inv_mass,
        inv_inertia=inv_inertia, body_friction=fric, plane_z=spec.plane_z,
        plane_friction=spec.plane_friction, plane_mu=fric * spec.plane_friction,
        finger_mu=fric * 1.0, plane_mask=plane_mask, geom_mask=geom_mask,
        gripper=gripper)


@dataclasses.dataclass(frozen=True)
class MultiBodyConsts:
    """Everything static that the control step of a scene of free and
    pinned bodies made of box geoms, static boxes and a prismatic door needs
    (`pallas_multibody.py:262-334`), per body in body order and per geom in
    geom order, in float32 where the kernels read it. A pinned body (the
    insertion slot) has inverse mass and inverse inertia 0: it gets no
    gravity, no plane lanes and no integration, and every lane against it
    treats it as the world. A static box (a chest wall) is the world at a
    fixed centre with the identity rotation. The door (the chest's) is one
    prismatic degree of freedom: its panels ride on the frame ``door_anchor
    + door_axis * door_q`` with the identity rotation."""
    nb: int
    # the geom table: each geom's body, half extents and offset in the body
    # frame (its centre is the body position plus R offset)
    geom_body: Tuple[int, ...]
    geom_half: Tuple[Tuple[float, float, float], ...]
    geom_pos: Tuple[Tuple[float, float, float], ...]
    inv_mass: Tuple[float, ...]
    inv_inertia: Tuple[Tuple[float, float, float], ...]   # body-frame diagonal
    body_friction: Tuple[float, ...]
    plane_z: float
    plane_friction: float
    # arm-sphere lanes kept by the workspace envelope (lane_cull), bit sp:
    # against the plane, and against each geom
    plane_mask: int
    geom_mask: Tuple[int, ...]
    # static boxes: half extents, world centres, frictions, and per static
    # the arm spheres that keep a lane on it (bit sp)
    static_half: Tuple[Tuple[float, float, float], ...] = ()
    static_pos: Tuple[Tuple[float, float, float], ...] = ()
    static_friction: Tuple[float, ...] = ()
    static_mask: Tuple[int, ...] = ()
    # the door: its kind (S.DOOR_NONE or S.DOOR_PRISMATIC), its joint frame's
    # world anchor and axis, its limit and inverse mass, its panels' half
    # extents and offsets in the joint frame, the arm spheres that keep a
    # lane on each panel (bit sp)
    door_kind: int = 0
    door_anchor: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    door_axis: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    door_limit: float = 0.0
    door_inv_mass: float = 0.0
    door_half: Tuple[Tuple[float, float, float], ...] = ()
    door_pos: Tuple[Tuple[float, float, float], ...] = ()
    door_mask: int = 0
    # 'parallel_jaw' or 'robotiq85': the pads' kinematics and `finger`
    gripper: str = 'parallel_jaw'
    solver_iters: int = 8
    erp: float = 0.2
    slop: float = 5e-4

    @property
    def finger(self) -> FingerConsts:
        return finger_consts(self.gripper)

    @property
    def ns(self):
        return len(self.static_half)

    @property
    def nd(self):
        """The door's panels (0 without a door)."""
        return len(self.door_half)

    @property
    def ng(self):
        return len(self.geom_body)

    @property
    def pinned(self):
        """Per body, whether it is pinned (mass 0 in the scene)."""
        return tuple(m == 0.0 for m in self.inv_mass)

    @property
    def geom_order(self):
        """The geoms in the lane plan's order: per body, its geoms."""
        return [g for b in range(self.nb) for g in range(self.ng)
                if self.geom_body[g] == b]

    @property
    def free_geoms(self):
        """The free bodies' geoms, in `geom_order`."""
        return [g for g in self.geom_order
                if not self.pinned[self.geom_body[g]]]

    @property
    def pinned_geoms(self):
        """The pinned bodies' geoms, in `geom_order`."""
        return [g for g in self.geom_order if self.pinned[self.geom_body[g]]]

    @property
    def geom_pairs(self):
        """The geom pairs of two free bodies in the lane plan's order: per
        pair of bodies b < b2, each geom of b with each geom of b2."""
        order = self.free_geoms
        return [(g, g2) for b in range(self.nb) for b2 in range(b + 1, self.nb)
                for g in order if self.geom_body[g] == b
                for g2 in order if self.geom_body[g2] == b2]

    # lane frictions (pallas_multibody.py:403-517)
    def mu_plane(self, b):
        return self.body_friction[b] * self.plane_friction

    def mu_finger(self, b):
        return self.body_friction[b] * 1.0

    def mu_sphere(self, b):
        return 0.5 * self.body_friction[b]

    def mu_pair(self, b, b2):
        return self.body_friction[b] * self.body_friction[b2]

    @property
    def mu_finger_plane(self):
        return 1.0 * self.plane_friction

    @property
    def mu_sphere_plane(self):
        return 0.5 * self.plane_friction

    def mu_static(self, b, s):
        return self.body_friction[b] * self.static_friction[s]

    def mu_door(self, b):
        return self.body_friction[b] * 0.5

    mu_finger_door = 1.0
    mu_sphere_door = 0.5

    def mu_finger_static(self, s):
        return 1.0 * self.static_friction[s]

    def mu_sphere_static(self, s):
        return 0.5 * self.static_friction[s]

    # the door's frame (JAX `dynamics.py:385-403`, `pallas_multibody.py:
    # 317-334`), prismatic: it slides along its axis and does not turn
    def door_frame(self, door_q):
        """The door joint frame's world position (N, 3) and orientation (N,
        4, wxyz) at joint values ``door_q`` (N,)."""
        pos = (const(self.door_anchor, door_q)
               + const(self.door_axis, door_q) * door_q[:, None])
        rot = const([1.0, 0.0, 0.0, 0.0], door_q).expand(door_q.shape[0], 4)
        return pos, rot

    def door_point_jac(self, p, door_q):
        """The velocity of door points ``p`` (..., 3) per unit door_qd: the
        axis, wherever the point is."""
        return const(self.door_axis, p).expand(p.shape)


def multibody_consts(spec: S.SceneSpec, ik_workspace: bool = True,
                     gripper: str = 'parallel_jaw') -> MultiBodyConsts:
    """Static constants of a multi-body scene of free and pinned bodies
    made of one or more box geoms of any size, with ``gripper`` (the
    multi-step family, the push-primitive family, insertion; the envs
    build the Robotiq-85's scenes only for the block tasks).
    ``ik_workspace=False`` (joint control) keeps every arm-sphere lane. A
    body of mass <= 0 is pinned: inverse mass and inverse inertia 0. A
    free body's inertia is that of its geom at the
    body origin alone, or a 1e-3 diagonal where it has none (the
    reference's convention, `pallas_multibody.py:273-281`). The chest's
    walls are static boxes and its sliding door a prismatic door
    (`pallas_multibody.py:301-309`). Raises `NotImplementedError` for what
    later slices of the port bring: the revolving door and cylinders."""
    later = 'come with a later slice of the port'
    if spec.door is not None and spec.door.kind != S.DOOR_PRISMATIC:
        raise NotImplementedError('the revolving chest door ' + later)
    a = spec.np_arrays()
    if (a['geom_type'] != S.BOX).any():
        raise NotImplementedError('cylinder bodies ' + later)
    reach = LC.arm_lane_mask(spec, ik_workspace)

    def mask(keep):
        return sum(1 << sp for sp in range(N_ARM_SPHERES) if keep[sp])

    def rows(x):
        return tuple(tuple(float(v) for v in r) for r in x)
    chest = {}
    if spec.ns_static:
        chest.update(
            static_half=rows(a['static_half']),
            static_pos=rows(a['static_pos']),
            static_friction=tuple(float(f) for f in a['static_friction']),
            static_mask=tuple(mask([reach['static'][sp][s]
                                    for sp in range(N_ARM_SPHERES)])
                              for s in range(spec.ns_static)))
    door = spec.door
    if door is not None:
        chest.update(
            door_kind=S.DOOR_PRISMATIC,
            door_anchor=tuple(float(x) for x in
                              np.asarray(spec.chest_base, np.float64)
                              + np.asarray(door.anchor, np.float64)),
            door_axis=tuple(float(x) for x in door.axis),
            door_limit=float(door.limit),
            door_inv_mass=1.0 / max(door.mass, 0.25),
            door_half=rows(np.asarray(door.geom_half).reshape(-1, 3)),
            door_pos=rows(np.asarray(door.geom_pos).reshape(-1, 3)),
            door_mask=mask(reach['door']))
    ng = len(a['geom_body'])
    inv_inertia = []
    for b in range(spec.n_bodies):
        if a['body_mass'][b] <= 0:
            inv_inertia.append((0.0, 0.0, 0.0))
            continue
        inertia = np.full(3, 1e-3)
        for g in range(ng):
            if a['geom_body'][g] == b and (a['geom_pos'][g] == 0).all():
                inertia = S.body_inertia_diag(
                    float(a['body_mass'][b]),
                    tuple(float(x) for x in a['geom_half'][g]), S.BOX)
        inv_inertia.append(tuple(float(x) for x in
                                 (1.0 / inertia).astype(np.float32)))
    return MultiBodyConsts(
        nb=spec.n_bodies,
        geom_body=tuple(int(b) for b in a['geom_body']),
        geom_half=tuple(tuple(float(x) for x in h) for h in a['geom_half']),
        geom_pos=tuple(tuple(float(x) for x in p) for p in a['geom_pos']),
        inv_mass=tuple(1.0 / float(m) if m > 0 else 0.0
                       for m in a['body_mass']),
        inv_inertia=tuple(inv_inertia),
        body_friction=tuple(float(f) for f in a['body_friction']),
        plane_z=spec.plane_z, plane_friction=spec.plane_friction,
        plane_mask=sum(1 << sp for sp in range(N_ARM_SPHERES)
                       if reach['plane'][sp]),
        geom_mask=tuple(sum(1 << sp for sp in range(N_ARM_SPHERES)
                            if reach['geom'][sp][g]) for g in range(ng)),
        gripper=gripper, **chest)


def init_state(n, nb=1, q=None, body_pos=None, body_quat=None,
               fq=KM.FINGER_LIMIT, device=None) -> PhysicsState:
    """A batch of n resting states with ``nb`` bodies (`Engine.init_state`):
    ``body_pos`` is (n, nb, 3), ``body_quat`` (n, nb, 4) wxyz or None for
    upright bodies."""
    z = torch.zeros((), dtype=torch.float32, device=device)
    if q is None:
        q = const(KM.KUKA_REST_POSE, z).expand(n, 7)
    if body_pos is None:
        body_pos = z.new_zeros((n, nb, 3))
    if body_quat is None:
        body_quat = const([1.0, 0.0, 0.0, 0.0], z).expand(n, nb, 4)
    return PhysicsState(
        q=q.to(z).expand(n, 7).contiguous(),
        qd=z.new_zeros((n, 7)),
        fq=z.new_full((n, 2), fq),
        fqd=z.new_zeros((n, 2)),
        body_pos=body_pos.to(z).contiguous(),
        body_quat=body_quat.to(z).contiguous(),
        body_linvel=z.new_zeros((n, nb, 3)),
        body_angvel=z.new_zeros((n, nb, 3)),
        door_q=z.new_zeros((n,)),
        door_qd=z.new_zeros((n,)),
        ee_contact_force=z.new_zeros((n, 3)))
