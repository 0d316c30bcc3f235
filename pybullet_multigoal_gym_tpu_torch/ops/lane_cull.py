"""Static contact-lane culling from the arm's reachable-workspace envelope.

The engines collide a 7-sphere approximation of the arm chain against every
scene feature (plane / movable geoms / static boxes / chest door). Most of
those pairs are *statically impossible*: when the arm tracks IK solutions for
tip targets inside the EE workspace box
(`pybullet_multigoal_gym/robots/kuka.py:40-51`), the
mid-arm spheres never come near the tabletop or the chest. Dropping those
lanes at plan-build time cuts the per-substep solver work by ~25-50%% with
zero physics change — the culled lanes could never activate.

Envelope derivation (tests/test_lane_cull.py re-derives and checks
conservativeness): sample thousands of IK solutions for tip targets over the
workspace box (including the corners), with the insertion family's +-0.6 rad
orientation wobble for the low box, PLUS joint-space interpolations between
random solution pairs (the servo's transient path between targets), then
take per-sphere extrema of world z / x / |y| and distance-to-tip. A safety
margin (MARGIN) is applied on top of every test.

The envelope only holds when the arm follows IK targets — joint-space
control (`joint_control=True`) can command any configuration within the
joint limits, so engines built for joint control keep every lane
(Engine(ik_workspace=False)).
"""

import numpy as np

from pybullet_multigoal_gym_tpu_torch.model import kuka_model as KM
from pybullet_multigoal_gym_tpu_torch.ops import scene as S

# Per-sphere reach envelopes (see module docstring; indices follow
# KM.ARM_SPHERE_*). 'table': single/multi-step families (EE workspace box
# x [-0.67,-0.37], y +-0.20, z [0.175, 0.55], fixed-down orientation).
# 'low': primitive/insertion families (x down to the primitive workspace
# -0.755, z down to 0.03, +-0.6 rad ZYZ wobble for the insertion family).
ENVELOPE = {
    'table': dict(
        min_z=[0.562, 0.515, 0.466, 0.412, 0.355, 0.274, 0.219],
        min_x=[-0.362, -0.437, -0.514, -0.618, -0.722, -0.722, -0.722],
        max_x=[0.048, -0.044, -0.136, -0.243, -0.349, -0.349, -0.349],
        max_abs_y=[0.125, 0.147, 0.169, 0.195, 0.226, 0.225, 0.225],
        min_tip_dist=[0.388, 0.311, 0.243, 0.193, 0.195, 0.114, 0.059]),
    'low': dict(
        min_z=[0.145, 0.141, 0.096, 0.043, -0.010, -0.050, -0.078],
        min_x=[-0.460, -0.552, -0.643, -0.750, -0.857, -0.828, -0.818],
        max_x=[0.160, 0.070, -0.017, -0.121, -0.225, -0.270, -0.279],
        max_abs_y=[0.355, 0.315, 0.309, 0.307, 0.314, 0.322, 0.329],
        min_tip_dist=[0.341, 0.266, 0.203, 0.169, 0.195, 0.114, 0.059]),
}

MARGIN = 0.05        # safety margin (m) on every reachability test
CARRY_SLACK = 0.05   # grasped-object centre vs tip slack


def envelope_for(spec: S.SceneSpec):
    """Pick the envelope matching the family's workspace (plane z 0.16 =
    table scenes; 0.02 = the low primitive/insertion workspace)."""
    return ENVELOPE['table'] if spec.plane_z > 0.1 else ENVELOPE['low']


def _sphere_aabb(env, sp):
    r = float(KM.ARM_SPHERE_RADIUS[sp])
    lo = np.array([env['min_x'][sp] - r, -env['max_abs_y'][sp] - r,
                   env['min_z'][sp] - r]) - MARGIN
    hi = np.array([env['max_x'][sp] + r, env['max_abs_y'][sp] + r,
                   np.inf]) + MARGIN
    return lo, hi


def _aabb_overlap(lo_a, hi_a, lo_b, hi_b):
    return bool(np.all(lo_a <= hi_b) and np.all(lo_b <= hi_a))


def sphere_plane_reachable(spec: S.SceneSpec, sp: int) -> bool:
    """Can arm sphere sp ever touch the support plane?"""
    env = envelope_for(spec)
    r = float(KM.ARM_SPHERE_RADIUS[sp])
    return env['min_z'][sp] - r - MARGIN <= spec.plane_z


def sphere_geom_reachable(spec: S.SceneSpec, sp: int, geom: int,
                          movable: bool, ground_z_top: float) -> bool:
    """Can arm sphere sp ever touch a body geom?

    A movable geom is reachable if the sphere dips into the on-ground band
    (z up to ``ground_z_top``: plane + tallest possible stack / chest lid)
    OR if the sphere can touch an object carried at the gripper tip
    (min tip distance test). Pinned geoms (insertion slot) only use the
    ground band at the geom's fixed height."""
    env = envelope_for(spec)
    r = float(KM.ARM_SPHERE_RADIUS[sp])
    half = np.asarray(spec.geom_half, np.float64).reshape(-1, 3)[geom]
    off = np.asarray(spec.geom_pos, np.float64).reshape(-1, 3)[geom]
    geom_rad = float(np.linalg.norm(half) + np.linalg.norm(off))
    on_ground = (env['min_z'][sp] - r - geom_rad - MARGIN) <= ground_z_top
    if not movable:
        return on_ground
    carried = (env['min_tip_dist'][sp] - r - geom_rad - CARRY_SLACK
               - MARGIN) <= 0.0
    return on_ground or carried


def sphere_box_reachable(spec: S.SceneSpec, sp: int, center, half) -> bool:
    """Can arm sphere sp ever touch a fixed world box (static / door sweep)?"""
    env = envelope_for(spec)
    lo_s, hi_s = _sphere_aabb(env, sp)
    c = np.asarray(center, np.float64)
    h = np.asarray(half, np.float64)
    return _aabb_overlap(lo_s, hi_s, c - h, c + h)


def door_sweep_aabb(spec: S.SceneSpec):
    """(center, half) of the AABB swept by all door geoms over the full
    joint range [0, limit]."""
    door = spec.door
    anchor = (np.asarray(spec.chest_base, np.float64)
              + np.asarray(door.anchor, np.float64))
    half = np.asarray(door.geom_half, np.float64).reshape(-1, 3)
    pos = np.asarray(door.geom_pos, np.float64).reshape(-1, 3)
    if door.kind == S.DOOR_PRISMATIC:
        axis = np.asarray(door.axis, np.float64)
        p0 = anchor + pos
        p1 = anchor + pos + axis * door.limit
        lo = np.minimum(p0, p1).min(0) - half.max(0)
        hi = np.maximum(p0, p1).max(0) + half.max(0)
    else:
        # revolute: conservative ball around the anchor
        r = (np.linalg.norm(pos, axis=-1) + np.linalg.norm(half, axis=-1)).max()
        lo, hi = anchor - r, anchor + r
    return (lo + hi) / 2.0, (hi - lo) / 2.0


def ground_z_top(spec: S.SceneSpec) -> float:
    """Highest z a movable geom can rest at: tallest block tower on the
    plane, or a block resting on the tallest static box / closed door."""
    halves = np.asarray(spec.geom_half, np.float64).reshape(-1, 3)
    if halves.size == 0:
        return spec.plane_z
    stack = spec.plane_z + float(2.0 * halves[:, 2].sum())
    tops = [stack]
    blk = float(2.0 * halves[:, 2].max())
    if spec.ns_static:
        sh = np.asarray(spec.static_half, np.float64).reshape(-1, 3)
        sp_ = np.asarray(spec.static_pos, np.float64).reshape(-1, 3)
        tops.append(float((sp_[:, 2] + sh[:, 2]).max()) + blk)
    if spec.door is not None:
        c, h = door_sweep_aabb(spec)
        tops.append(float(c[2] + h[2]) + blk)
    return max(tops)


def arm_lane_mask(spec: S.SceneSpec, ik_workspace: bool = True):
    """Per-(sphere, partner) keep/cull decisions for one scene.

    Returns dict with boolean lists: 'plane' (N_SPH,), 'geom' (N_SPH, NG),
    'static' (N_SPH, NS), 'door' (N_SPH,). All True when ik_workspace is
    False (joint-space control can reach anything)."""
    nsph = len(KM.ARM_SPHERE_RADIUS)
    a = spec.np_arrays() if spec.n_bodies else None
    ng = len(a['geom_body']) if spec.n_bodies else 0
    ns = spec.ns_static
    if not ik_workspace:
        return dict(plane=[True] * nsph, geom=[[True] * ng] * nsph,
                    static=[[True] * ns] * nsph, door=[True] * nsph)
    gzt = ground_z_top(spec)
    plane = [sphere_plane_reachable(spec, sp) for sp in range(nsph)]
    geom = [[sphere_geom_reachable(
        spec, sp, g, movable=a['body_mass'][a['geom_body'][g]] > 0,
        ground_z_top=gzt) for g in range(ng)] for sp in range(nsph)]
    static = [[sphere_box_reachable(spec, sp, a['static_pos'][s],
                                    a['static_half'][s])
               for s in range(ns)] for sp in range(nsph)]
    if spec.door is not None:
        c, h = door_sweep_aabb(spec)
        door = [sphere_box_reachable(spec, sp, c, h) for sp in range(nsph)]
    else:
        door = [False] * nsph
    return dict(plane=plane, geom=geom, static=static, door=door)
