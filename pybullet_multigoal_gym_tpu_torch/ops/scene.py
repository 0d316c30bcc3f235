"""Static scene specifications for the physics engine.

The reference loads URDFs at runtime into the Bullet world
(`pybullet_multigoal_gym/envs/base_envs/*_task_reset`). Here a
scene is compiled offline into plain numpy constants that become compile-time
constants of the step kernels: dynamic 6-DoF bodies (with one or more box/
cylinder geoms), static box geoms, an infinite support plane (the table top)
and an optional articulated 1-DoF chest door.

Geometry sources (all `pybullet_multigoal_gym/assets/objects/`):
  block*.urdf          0.03 cube, mass 2, friction 1.0, inertia_scaling 3.0
  table.urdf           static box 0.5x0.7x0.16, friction 0.1
  long_table.urdf      static box 1.0x0.9x0.16, friction 0.05 (slide task)
  cylinder_bulk.urdf   puck r=0.03 l=0.02, mass 2, friction 1.0
  chest_*.urdf         static walls + 1-DoF door + handle
  assembling_shape/*   workspace plate, cube/slot/rectangle (mass 100)
  insertion/*          workspace, rectangle (mass 100), static slot
"""

import dataclasses
from typing import Optional, Tuple

import numpy as np

BOX = 0
CYLINDER = 1

# Door articulation types
DOOR_NONE = 0
DOOR_PRISMATIC = 1
DOOR_REVOLUTE = 2


@dataclasses.dataclass(frozen=True)
class DoorSpec:
    """1-DoF chest door (chest_*.urdf). Frame: chest base frame."""
    kind: int                      # DOOR_PRISMATIC / DOOR_REVOLUTE
    anchor: Tuple[float, ...]      # joint origin in chest base frame
    axis: Tuple[float, ...]        # joint axis in chest base frame
    limit: float                   # upper joint limit (lower = 0)
    mass: float
    # door geoms in the door joint frame: (G,3) half extents + (G,3) centers
    geom_half: Tuple
    geom_pos: Tuple
    opened_state: float            # Chest.chest_door_opened_state


@dataclasses.dataclass(frozen=True)
class SceneSpec:
    """Everything static about a task family's physical world."""
    # dynamic bodies ---------------------------------------------------------
    n_bodies: int
    body_mass: Tuple                # (NB,)
    body_friction: Tuple            # (NB,)
    # flattened geom list for dynamic bodies
    geom_body: Tuple                # (NG,) body index of each geom
    geom_type: Tuple                # (NG,) BOX / CYLINDER
    geom_half: Tuple                # (NG,3) half extents (cyl: r,r,l/2)
    geom_pos: Tuple                 # (NG,3) offset in body frame
    # static geoms -----------------------------------------------------------
    ns_static: int
    static_half: Tuple              # (NS,3)
    static_pos: Tuple               # (NS,3) world position
    static_friction: Tuple          # (NS,)
    # support plane (table top)
    plane_z: float
    plane_friction: float
    # chest ------------------------------------------------------------------
    chest_base: Tuple               # chest base world position (0,0,0 if none)
    door: Optional[DoorSpec]

    def np_arrays(self):
        return {
            'body_mass': np.asarray(self.body_mass, np.float32).reshape(self.n_bodies),
            'body_friction': np.asarray(self.body_friction, np.float32).reshape(self.n_bodies),
            'geom_body': np.asarray(self.geom_body, np.int32).reshape(-1),
            'geom_type': np.asarray(self.geom_type, np.int32).reshape(-1),
            'geom_half': np.asarray(self.geom_half, np.float32).reshape(-1, 3),
            'geom_pos': np.asarray(self.geom_pos, np.float32).reshape(-1, 3),
            'static_half': np.asarray(self.static_half, np.float32).reshape(-1, 3),
            'static_pos': np.asarray(self.static_pos, np.float32).reshape(-1, 3),
            'static_friction': np.asarray(self.static_friction, np.float32).reshape(-1),
        }


def _t(x):
    return tuple(map(tuple, np.asarray(x, np.float64)))


BLOCK_HALF = 0.015
BLOCK_MASS = 2.0
INERTIA_SCALING = 3.0          # block/cylinder/finger URDF <inertia_scaling>


def body_inertia_diag(mass, half, geom_type=BOX, scaling=INERTIA_SCALING):
    """Diagonal inertia of a primitive, with Bullet's inertia_scaling."""
    hx, hy, hz = half
    if geom_type == BOX:
        ix = mass / 3.0 * (hy * hy + hz * hz)
        iy = mass / 3.0 * (hx * hx + hz * hz)
        iz = mass / 3.0 * (hx * hx + hy * hy)
    else:
        r, l = hx, 2 * hz
        ix = iy = mass * (3 * r * r + l * l) / 12.0
        iz = mass * r * r / 2.0
    return np.array([ix, iy, iz]) * scaling


def single_step_scene(has_obj: bool, table_type: str = 'table') -> SceneSpec:
    """Reach / Push / PickAndPlace (table) and Slide (long_table + puck).

    Table placement per `kuka_single_step_base_env.py:48-56`: table base at
    x=-0.52 (or -0.70 long), z=0.08, box height 0.16 -> top plane z=0.16.
    """
    if table_type == 'long_table':
        friction = 0.05
        geoms = dict(geom_type=[CYLINDER], geom_half=[[0.03, 0.03, 0.01]])
    else:
        friction = 0.1
        geoms = dict(geom_type=[BOX], geom_half=[[BLOCK_HALF] * 3])
    if not has_obj:
        return SceneSpec(
            n_bodies=0, body_mass=(), body_friction=(),
            geom_body=(), geom_type=(), geom_half=(), geom_pos=(),
            ns_static=0, static_half=(), static_pos=(), static_friction=(),
            plane_z=0.16, plane_friction=friction,
            chest_base=(0.0, 0.0, 0.0), door=None)
    return SceneSpec(
        n_bodies=1, body_mass=(BLOCK_MASS,), body_friction=(1.0,),
        geom_body=(0,), geom_type=tuple(geoms['geom_type']),
        geom_half=_t(geoms['geom_half']), geom_pos=_t([[0, 0, 0]]),
        ns_static=0, static_half=(), static_pos=(), static_friction=(),
        plane_z=0.16, plane_friction=friction,
        chest_base=(0.0, 0.0, 0.0), door=None)


# Chest geometry, chest_*.urdf (chest base frame = chest_back_wall frame).
_CHEST_WALLS = {
    # name: (half extents, center offset)
    'back': ([0.005, 0.07, 0.05], [0.0, 0.0, 0.0]),
    'front': ([0.005, 0.07, 0.05], [0.10, 0.0, 0.0]),
    'left': ([0.045, 0.005, 0.05], [0.05, 0.065, 0.0]),
    'right': ([0.045, 0.005, 0.05], [0.05, -0.065, 0.0]),
}


def _chest_statics(chest_base, door_kind):
    names = ['back', 'left', 'right'] if door_kind == 'front_sliding' \
        else ['back', 'front', 'left', 'right']
    half, pos = [], []
    for n in names:
        h, c = _CHEST_WALLS[n]
        half.append(h)
        pos.append(list(np.asarray(chest_base) + np.asarray(c)))
    return half, pos


def _door_spec(door_kind: str) -> DoorSpec:
    if door_kind == 'up_sliding':
        # chest_up_sliding_door.urdf: prismatic lid, origin (0.05,0,0.057),
        # axis (-1,0,0), range 0..0.10; lid box 0.11x0.14x0.01 + handle.
        return DoorSpec(
            kind=DOOR_PRISMATIC, anchor=(0.05, 0.0, 0.057), axis=(-1.0, 0.0, 0.0),
            limit=0.10, mass=2.0,
            geom_half=_t([[0.055, 0.07, 0.005], [0.02, 0.01, 0.01]]),
            geom_pos=_t([[0.0, 0.0, 0.0], [0.07, 0.065, 0.025]]),
            opened_state=0.1)
    if door_kind == 'front_sliding':
        # chest_front_sliding_door.urdf: prismatic front face, origin
        # (0.103,0,0), axis (0,1,0), range 0..0.12; face box 0.01x0.14x0.10.
        return DoorSpec(
            kind=DOOR_PRISMATIC, anchor=(0.103, 0.0, 0.0), axis=(0.0, 1.0, 0.0),
            limit=0.12, mass=0.5,
            geom_half=_t([[0.005, 0.07, 0.05], [0.02, 0.01, 0.01]]),
            geom_pos=_t([[0.0, 0.0, 0.0], [0.03, 0.0, 0.04]]),
            opened_state=0.12)
    # chest_revolving_door.urdf: revolute about z at chest top, 0..1.57.
    return DoorSpec(
        kind=DOOR_REVOLUTE, anchor=(0.0, 0.0, 0.055), axis=(0.0, 0.0, 1.0),
        limit=1.57, mass=2.0,
        geom_half=_t([[0.05, 0.07, 0.005], [0.01, 0.01, 0.02]]),
        geom_pos=_t([[0.055, 0.0, 0.0], [0.105, 0.0, 0.0]]),
        opened_state=1.57)


def multi_step_scene(num_block: int, chest: bool = False,
                     chest_door: str = 'front_sliding') -> SceneSpec:
    """Block-stack / rearrange / chest tasks: table + up to 5 blocks (+chest).

    Chest base position per `kuka_multi_step_base_env.py:64`: (-0.7, 0, 0.21).
    """
    chest_base = (-0.7, 0.0, 0.21)
    statics_half, statics_pos, statics_fric = [], [], []
    door = None
    if chest:
        h, p = _chest_statics(chest_base, chest_door)
        statics_half += h
        statics_pos += p
        statics_fric += [0.5] * len(h)
        door = _door_spec(chest_door)
    nb = num_block
    return SceneSpec(
        n_bodies=nb,
        body_mass=(BLOCK_MASS,) * nb,
        body_friction=(1.0,) * nb,
        geom_body=tuple(range(nb)),
        geom_type=(BOX,) * nb,
        geom_half=_t([[BLOCK_HALF] * 3] * nb),
        geom_pos=_t([[0, 0, 0]] * nb),
        ns_static=len(statics_half),
        static_half=_t(statics_half) if statics_half else (),
        static_pos=_t(statics_pos) if statics_pos else (),
        static_friction=tuple(statics_fric),
        plane_z=0.16, plane_friction=0.1,
        chest_base=chest_base, door=door)


def shape_assemble_scene(manipulated_object_keys) -> SceneSpec:
    """Primitive-push tasks: workspace plate + cube/slot or rectangle.

    assets/objects/assembling_shape: workspace 0.5x0.5x0.02 at z=0.01 ->
    top plane z=0.02, friction 0.1; objects mass 100, friction 1.0.
    slot = base (0.03x0.09x0.03) + left/right cubes at (-0.03, +-0.03, 0).
    """
    masses, frictions, gb, gt, gh, gp = [], [], [], [], [], []
    for key in manipulated_object_keys:
        b = len(masses)
        masses.append(100.0)
        frictions.append(1.0)
        if key == 'cube':
            gb += [b]; gt += [BOX]; gh += [[0.015] * 3]; gp += [[0, 0, 0]]
        elif key == 'rectangle':
            gb += [b]; gt += [BOX]; gh += [[0.015, 0.04, 0.015]]; gp += [[0, 0, 0]]
        elif key == 'slot':
            gb += [b, b, b]
            gt += [BOX] * 3
            gh += [[0.015, 0.045, 0.015], [0.015, 0.015, 0.015], [0.015, 0.015, 0.015]]
            gp += [[0, 0, 0], [-0.03, 0.03, 0], [-0.03, -0.03, 0]]
        else:
            raise ValueError(key)
    return SceneSpec(
        n_bodies=len(masses), body_mass=tuple(masses), body_friction=tuple(frictions),
        geom_body=tuple(gb), geom_type=tuple(gt), geom_half=_t(gh), geom_pos=_t(gp),
        ns_static=0, static_half=(), static_pos=(), static_friction=(),
        plane_z=0.02, plane_friction=0.1,
        chest_base=(0.0, 0.0, 0.0), door=None)


def insertion_scene() -> SceneSpec:
    """Insertion: workspace + upright rectangle (mass 100) + STATIC slot.

    assets/objects/insertion: rectangle 0.03x0.03x0.08 with a grasp_target
    frame +0.03 z; slot links mass 0 (static): base (0.03x0.09x0.03) +
    left/right cubes + end bar at (-0.06,0,0); slot_target = link 3 frame.
    The slot's world pose is randomised per episode, so its geoms are modelled
    as a zero-mass *body* pinned in place (infinite effective mass).
    """
    return SceneSpec(
        n_bodies=2,
        body_mass=(100.0, 0.0),          # mass 0 -> kinematically pinned
        body_friction=(1.0, 1.0),
        geom_body=(0, 1, 1, 1, 1),
        geom_type=(BOX,) * 5,
        geom_half=_t([[0.015, 0.015, 0.04],
                      [0.015, 0.045, 0.015], [0.015, 0.015, 0.015],
                      [0.015, 0.015, 0.015], [0.015, 0.045, 0.015]]),
        geom_pos=_t([[0, 0, 0],
                     [0, 0, 0], [-0.03, 0.03, 0], [-0.03, -0.03, 0],
                     [-0.06, 0, 0]]),
        ns_static=0, static_half=(), static_pos=(), static_friction=(),
        plane_z=0.02, plane_friction=0.1,
        chest_base=(0.0, 0.0, 0.0), door=None)
