"""Plain PyTorch version of kernel K2: the fused 100-substep control step.

Counterpart of `pybullet_multigoal_gym_tpu/ops/pallas_engine.py` (the tile
algebra, `fk_chain`, the lane builders and `substep`), written over a
leading env axis instead of (8, 128) tiles: a vector is (N, 3), a rotation
matrix (N, 3, 3) with rows first, and contact lanes stack on axis 1. The
lane order, the static per-lane solver metadata and the group bounds
``n_link`` / ``n_cpl`` are those of `pallas_engine.py:573-657`, because the
per-body, per-finger and per-arm sums depend on them.

The CPU path and the tests run this module; on the card `ops/cuda_engine.py`
launches `csrc/engine.cu` instead, and the chip smoke test holds the two
against each other. Scope: the no-object scene (reach), one free box
(push, pick_and_place) and one free upright cylinder (slide's puck) with the
parallel-jaw or the Robotiq-85 gripper. The lane builders
(and the edge-edge lane, which only K3 uses) also serve K3's plain version,
`ops/multibody_plain.py`.
"""

from typing import NamedTuple

import numpy as np
import torch

from pybullet_multigoal_gym_tpu_torch.maths import quat as quatm
from pybullet_multigoal_gym_tpu_torch.model import kuka_model as KM
from pybullet_multigoal_gym_tpu_torch.ops import dynamics as D
from pybullet_multigoal_gym_tpu_torch.ops import fk
from pybullet_multigoal_gym_tpu_torch.ops import scene as S
from pybullet_multigoal_gym_tpu_torch.utils.tensors import const, index

F32 = np.float32
_ARM_INERTIA = np.asarray(KM.ARM_EFFECTIVE_INERTIA, F32)
_INV_ARM_INERTIA = (1.0 / _ARM_INERTIA).astype(F32)
_ARM_DV = KM.ARM_PD_FORCE * D.DT_SUB / _ARM_INERTIA          # servo authority
_ARM_CAP = [float(KM.ARM_PD_FORCE * D.DT_SUB * _INV_ARM_INERTIA[j])
            for j in range(7)]                                # coupling cap
_JL_LO = np.asarray(KM.JOINT_LIMIT_LOWER, F32)
_JL_HI = np.asarray(KM.JOINT_LIMIT_UPPER, F32)
_EZ = (0.0, 0.0, 1.0)


# ---------------------------------------------------------------- algebra
vcross = quatm.cross
qmul = quatm.mul
qrotate = quatm.rotate
qmat = quatm.to_matrix


def vdot(a, b):
    return (a * b).sum(-1)


def mat3vec(R, v):
    """R (..., 3, 3) @ v (..., 3)."""
    return (R * v[..., None, :]).sum(-1)


def qnormalize(q):
    return q * torch.rsqrt((q * q).sum(-1, keepdim=True).clamp_min(1e-12))


def _col(R, k):
    return R[..., :, k]


# --------------------------------------------------------------------- FK
def fk_chain(q, fq, gripper: str = 'parallel_jaw'):
    """FK of the whole arm chain plus the finger and arm-sphere placement
    (`pallas_engine.py:fk_chain`): the parallel jaw's pads slide along
    their axes from the gripper base, the Robotiq-85's hang from link 7's
    origin on the linkage (`fk.robotiq_pads`).

    Returns a dict of tensors: joint origins ``o`` (N, 7, 3), rotations
    ``rots`` (N, 7, 4), joint z axes ``z`` (N, 7, 3), link-7 quat ``r7``,
    ``gbase``, finger box centres ``fpos`` (N, 2, 3), finger axes ``faxis``
    (N, 2, 3; the pad velocity per unit finger rate) and the arm collision
    sphere centres ``spheres`` (N, 7, 3)."""
    o, rots = fk.link_frames(q)
    z = qrotate(rots, const(_EZ, q))
    r7 = rots[:, 6]
    gbase = o[:, 6] + qrotate(r7, const(KM.GRIPPER_BASE_OFFSET, q))
    r7f = r7[:, None]
    if gripper == 'robotiq85':
        pads = fk.robotiq_pads(fq)
        fpos = o[:, 6, None] + qrotate(r7f, pads['center'])
        faxis = qrotate(r7f, pads['vel'])
    else:
        axis = const(KM.FINGER_AXIS, q)
        loc = const(KM.FINGER_ORIGIN, q) + axis * fq[:, :, None]
        fpos = gbase[:, None] + qrotate(r7f, loc)
        faxis = qrotate(r7f, axis)
    li = index(KM.ARM_SPHERE_LINK, q)
    spheres = o[:, li] + qrotate(rots[:, li], const(KM.ARM_SPHERE_OFFSET, q))
    return dict(o=o, rots=rots, z=z, r7=r7, gbase=gbase, fpos=fpos,
                faxis=faxis, spheres=spheres)


# ------------------------------------------------------------------ lanes
class Lane(NamedTuple):
    """One contact lane plus its static solver metadata
    (`pallas_engine.py:_Lane`): body_sgn is +-1 when the free body is on
    side A/B; finger_idx / fin_sgn couple a finger DOF; link masks the arm
    velocity Jacobian to joints 0..link (-1 = no arm part); arm_sgn signs the
    arm coupling; couple = 1 lets the arm yield in-solve; ee_sgn signs the
    lane's share of the EE force sensor."""
    pt: torch.Tensor        # (N, 3)
    nrm: torch.Tensor       # (N, 3)
    pen: torch.Tensor       # (N,)
    active: torch.Tensor    # (N,) float 0/1
    mu: float
    body_sgn: float
    finger_idx: int
    fin_sgn: float
    link: int
    arm_sgn: float
    couple: float
    ee_sgn: float


def _mk_lane(pt, nrm, pen, active, mu, body_sgn=0.0, finger_idx=-1,
             fin_sgn=0.0, link=-1, arm_sgn=0.0, couple=0.0, ee_sgn=0.0):
    return Lane(pt, nrm, pen, active, mu, body_sgn, finger_idx, fin_sgn,
                link, arm_sgn, couple, ee_sgn)


def _sign(x):
    return torch.where(x >= 0, 1.0, -1.0)


def incident_corners(c, R, h, d):
    """The 4 corners of the box face most facing direction d
    (`pallas_engine.py:incident_corner_tiles`). Returns a list of 4 (N, 3)."""
    cols = [_col(R, k) for k in range(3)]
    dots = [vdot(d, cols[k]) for k in range(3)]
    ad = [x.abs() for x in dots]
    m0 = ((ad[0] >= ad[1]) & (ad[0] >= ad[2])).float()
    m1 = (1.0 - m0) * (ad[1] >= ad[2]).float()
    m2 = 1.0 - m0 - m1
    m = [m0[:, None], m1[:, None], m2[:, None]]
    sgn = [_sign(dots[k])[:, None] for k in range(3)]
    f = sum(m[k] * sgn[k] * h[k] * cols[k] for k in range(3))
    u = sum(m[k] * h[(k + 1) % 3] * cols[(k + 1) % 3] for k in range(3))
    v = sum(m[k] * h[(k + 2) % 3] * cols[(k + 2) % 3] for k in range(3))
    base = c + f
    return [base - u - v, base - u + v, base + u - v, base + u + v]


def box_plane_lanes(bp, bq, half, plane_z, mu, **meta):
    """4-lane box vs plane: the bottom-face incident corners."""
    R = qmat(bq)
    up = const(_EZ, bp).expand(bp.shape)
    lanes = []
    for corner in incident_corners(bp, R, half, const([0.0, 0.0, -1.0], bp)):
        pen = plane_z - corner[:, 2]
        lanes.append(_mk_lane(corner, up, pen, (pen > -1e-4).float(), mu,
                              **meta))
    return lanes


# the cylinder's 4 rim points at angles 2 pi k / 4, as float32 factors of
# the radius (the kernel's RIM_COS / RIM_SIN)
_RIM_COS = [F32(np.cos(2.0 * np.pi * k / 4)) for k in range(4)]
_RIM_SIN = [F32(np.sin(2.0 * np.pi * k / 4)) for k in range(4)]


def cyl_plane_lanes(bp, bq, radius, half_len, plane_z, mu, **meta):
    """4-lane upright cylinder vs plane: the bottom cap's rim points at 0,
    90, 180 and 270 degrees (`pallas_engine.py:_cyl_plane_lanes`), placed
    with the quaternion."""
    r, hl = F32(radius), F32(half_len)
    up = const(_EZ, bp).expand(bp.shape)
    lanes = []
    for k in range(4):
        loc = const([r * _RIM_COS[k], r * _RIM_SIN[k], -hl], bp)
        pt = bp + qrotate(bq, loc.expand(bp.shape))
        pen = plane_z - pt[:, 2]
        lanes.append(_mk_lane(pt, up, pen, (pen > -1e-4).float(), mu, **meta))
    return lanes


def box_cyl_lanes(cb, Rb, hb, cc, radius, half_len, mu, **meta):
    """Box (side B: a finger pad) vs upright cylinder (side A: the puck): a
    lateral and a vertical lane, exclusive, keyed on the smaller
    penetration (`pallas_engine.py:box_cyl_lanes`, `contact.py:
    box_cylinder_upright`); the normals point from the box toward the
    cylinder. Where the cylinder's axis lies inside the box in the box's
    xy, the lateral lane leaves through the nearer side face. The vertical
    lane's point is the cap centre along the world normal, as the Pallas
    kernel places it (the XLA engine uses the box-frame normal there)."""
    r, hl = F32(radius), F32(half_len)
    hb = [F32(h) for h in hb]
    rel = cc - cb
    cl = [vdot(_col(Rb, i), rel) for i in range(3)]
    delta = [cl[i] - cl[i].clamp(float(-hb[i]), float(hb[i]))
             for i in range(2)]
    d_xy = torch.sqrt(delta[0] * delta[0] + delta[1] * delta[1])
    outside = (d_xy > 1e-6).float()
    e0 = float(hb[0]) - cl[0].abs()
    e1 = float(hb[1]) - cl[1].abs()
    is0 = (e0 <= e1).float()
    emin = torch.minimum(e0, e1)
    lat_pen = (float(r) - d_xy) * outside + (float(r) + emin) * (1.0 - outside)
    inv = 1.0 / d_xy.clamp_min(1e-6)
    nx = delta[0] * inv * outside + is0 * _sign(cl[0]) * (1.0 - outside)
    ny = delta[1] * inv * outside + (1.0 - is0) * _sign(cl[1]) * (1.0 - outside)
    n_lat = mat3vec(Rb, torch.stack([nx, ny, torch.zeros_like(nx)], -1))
    p_lat = cc - n_lat * float(r)
    z_reach = float(hb[2] + hl)
    vert_pen = z_reach - cl[2].abs()
    in_xy = ((cl[0].abs() < float(hb[0] + r))
             & (cl[1].abs() < float(hb[1] + r))).float()
    side_is_min = (lat_pen <= vert_pen).float()
    lat_act = ((lat_pen > -1e-4) & (cl[2].abs() < z_reach)).float() \
        * side_is_min
    vert_act = (vert_pen > -1e-4).float() * in_xy * (1.0 - side_is_min)
    sz = _sign(cl[2])
    zero = torch.zeros_like(sz)
    n_vert = mat3vec(Rb, torch.stack([zero, zero, sz], -1))
    p_vert = cc - n_vert * float(hl)
    return [_mk_lane(p_lat, n_lat, lat_pen, lat_act, mu, **meta),
            _mk_lane(p_vert, n_vert, vert_pen, vert_act, mu, **meta)]


def _proj(R, h, L):
    # sum_i h_i |(R col_i) . L|
    return sum(vdot(_col(R, i), L).abs() * h[i] for i in range(3))


def _proj_rows(Rt, h, L):
    """sum_i h_i |(R col_i) . L| for directions L (N, k, 3); ``Rt`` is R
    transposed (N, 3, 3), its rows R's columns."""
    d = (L[:, :, None, :] * Rt[:, None]).sum(-1)            # (N, k, 3)
    return d[..., 0].abs() * h[0] + d[..., 1].abs() * h[1] \
        + d[..., 2].abs() * h[2]


def sat_face_normal(ca, Ra, ha, cb, Rb, hb):
    """Minimum-penetration face axis over the 6 face axes of two OBBs (all
    6 at once; the first minimum wins, as in the Pallas kernel's loop).
    Returns (n pointing B->A, sat_ok, ra_n, rb_n, min_overlap)."""
    RaT, RbT = Ra.transpose(-1, -2), Rb.transpose(-1, -2)
    axes = torch.cat([RaT, RbT], 1)                          # (N, 6, 3)
    tl = vdot((ca - cb)[:, None], axes)
    overlap = (_proj_rows(RaT, ha, axes) + _proj_rows(RbT, hb, axes)
               - tl.abs())
    sat_ok = (overlap > -1e-4).float().prod(1)
    best = overlap.argmin(1)
    rows = torch.arange(best.shape[0], device=best.device)
    n = axes[rows, best] * _sign(tl[rows, best])[:, None]
    return (n, sat_ok, _proj(Ra, ha, n), _proj(Rb, hb, n),
            overlap[rows, best])


def point_in_box(p, c, R, h):
    """0/1 mask of points inside an OBB (with the contact margin)."""
    rel = p - c
    out = None
    for i in range(3):
        ok = (h[i] - vdot(_col(R, i), rel).abs() > -1e-4).float()
        out = ok if out is None else out * ok
    return out


def clamp_into_box(p, c, R, h):
    """Closest point of an OBB to p: c + R clip(R^T (p - c), +-h)."""
    rel = p - c
    loc = torch.stack([vdot(_col(R, i), rel).clamp(-h[i], h[i])
                       for i in range(3)], -1)
    return c + mat3vec(R, loc)


def sat_box_box_lanes(ca, Ra, ha, cb, Rb, hb, mu, one_sided=False, **meta):
    """9-lane SAT box-box manifold: 4 incident-face corners of A in B, 4 of
    B in A, 1 cross-piercing fallback (the 4 corners of a side at once).
    ``one_sided`` (B immovable: a pinned body, a static wall) keeps A's
    corners and the fallback, 5 lanes (`pallas_multibody.py:_one_sided`)."""
    n, sat_ok, ra_n, rb_n, min_overlap = sat_face_normal(ca, Ra, ha,
                                                         cb, Rb, hb)
    n4 = n[:, None]
    # A corners toward B, then B corners toward A
    pa = torch.stack(incident_corners(ca, Ra, ha, -n), 1)    # (N, 4, 3)
    pen_a = rb_n[:, None] - vdot(n4, pa - cb[:, None])
    in_a = point_in_box(pa, cb[:, None], Rb[:, None], hb)
    sides = [(pa, pen_a, in_a)]
    if not one_sided:
        pb = torch.stack(incident_corners(cb, Rb, hb, n), 1)
        pen_b = vdot(n4, pb - ca[:, None]) + ra_n[:, None]
        in_b = point_in_box(pb, ca[:, None], Ra[:, None], ha)
        sides.append((pb, pen_b, in_b))
    inside_any = torch.cat([x[2] for x in sides], 1).amax(1)
    lanes = [_mk_lane(p[:, k], n, pen[:, k], inside[:, k] * sat_ok, mu,
                      **meta)
             for p, pen, inside in sides for k in range(4)]
    # cross-piercing fallback: SAT overlap but no corner inside either box
    p_cross = 0.5 * (clamp_into_box(ca, cb, Rb, hb)
                     + clamp_into_box(cb, ca, Ra, ha))
    lanes.append(_mk_lane(p_cross, n, min_overlap,
                          sat_ok * (1.0 - inside_any), mu, **meta))
    return lanes


def edge_lane(ca, Ra, ha, cb, Rb, hb, mu, **meta):
    """Edge-edge candidate of box A vs box B (`pallas_engine.py:
    edge_lane_tiles`, `contact.py:box_box_edge`): 1 lane, active when an
    edge-cross axis is the 15-axis SAT minimum by more than 20 % + 1 mm of
    the best face axis. The 9 edge pairs (i, j) are computed at once, in
    the Pallas kernel's order of operations; the first minimum wins."""
    t = ca - cb
    min_f = sat_ok = None
    for L in [_col(Ra, k) for k in range(3)] + [_col(Rb, k) for k in range(3)]:
        ov = _proj(Ra, ha, L) + _proj(Rb, hb, L) - vdot(t, L).abs()
        ok = (ov > -1e-4).float()
        sat_ok = ok if sat_ok is None else sat_ok * ok
        min_f = ov if min_f is None else torch.minimum(min_f, ov)
    # pair p = 3 i + j: edge axis i of A, j of B
    ii, jj = [p // 3 for p in range(9)], [p % 3 for p in range(9)]
    ea = Ra[..., :, index(ii, Ra)].transpose(-1, -2)
    eb = Rb[..., :, index(jj, Rb)].transpose(-1, -2)
    cA = [_col(Ra, k)[:, None] for k in range(3)]           # (N, 1, 3)
    cB = [_col(Rb, k)[:, None] for k in range(3)]
    t9 = t[:, None]
    L = vcross(ea, eb)                                      # (N, 9, 3)
    Ln = torch.sqrt(vdot(L, L).clamp_min(1e-18))
    Lu = L / Ln[..., None]
    ov = (sum(vdot(cA[k], Lu).abs() * ha[k] for k in range(3))
          + sum(vdot(cB[k], Lu).abs() * hb[k] for k in range(3))
          - vdot(t9, Lu).abs())
    ov = torch.where(Ln > 1e-6, ov, 1e9)        # parallel edges: no axis
    sat_ok = sat_ok * (ov > -1e-4).float().prod(1)
    n9 = Lu * _sign(vdot(t9, Lu))[..., None]
    # the support edges: A's edge along ea nearest B, B's along eb
    pa, pb = ca[:, None], cb[:, None]
    for k in range(3):
        offA = (_sign(vdot(-n9, cA[k])) * ha[k])[..., None] * cA[k]
        offB = (_sign(vdot(n9, cB[k])) * hb[k])[..., None] * cB[k]
        pa = pa + torch.where(const([i != k for i in ii], t)[:, None] > 0,
                              offA, 0.0)
        pb = pb + torch.where(const([j != k for j in jj], t)[:, None] > 0,
                              offB, 0.0)
    # closest points of the two edge lines, clamped to the edges
    r = pa - pb
    b_, c_, d_ = vdot(ea, eb), vdot(ea, r), vdot(eb, r)
    den = (1.0 - b_ * b_).clamp_min(1e-9)
    s_ = (b_ * d_ - c_) / den
    u_ = d_ + b_ * s_
    s_ = torch.minimum(torch.maximum(s_, -const([ha[i] for i in ii], t)),
                       const([ha[i] for i in ii], t))
    u_ = torch.minimum(torch.maximum(u_, -const([hb[j] for j in jj], t)),
                       const([hb[j] for j in jj], t))
    pt9 = 0.5 * (pa + s_[..., None] * ea + pb + u_[..., None] * eb)
    best = ov.argmin(1)                          # the first minimum
    rows = torch.arange(ov.shape[0], device=ov.device)
    min_e, n, pt = ov[rows, best], n9[rows, best], pt9[rows, best]
    edge_wins = (min_e < torch.minimum(min_f * 0.8, min_f) - 1e-3).float()
    active = sat_ok * edge_wins * (min_e > -1e-4).float()
    return [_mk_lane(pt, n, min_e, active, mu, **meta)]


def sphere_plane_lane(c, radius, plane_z, mu, **meta):
    """Sphere vs support plane: 1 lane."""
    pen = (plane_z + radius) - c[:, 2]
    p = c - const(_EZ, c) * radius
    return [_mk_lane(p, const(_EZ, c).expand(c.shape), pen,
                     (pen > -1e-4).float(), mu, **meta)]


def sphere_box_lane(c, radius, cb, Rb, hb, mu, **meta):
    """Sphere (A) vs box (B): 1 lane; the normal pushes the sphere out.
    ``radius`` is a float or one per row, (N,)."""
    rel = c - cb
    cl = [vdot(_col(Rb, i), rel) for i in range(3)]
    delta = torch.stack([cl[i] - cl[i].clamp(-hb[i], hb[i])
                         for i in range(3)], -1)
    dd = vdot(delta, delta)
    d = torch.sqrt(dd.clamp_min(1e-18))
    outside = (dd > 1e-18).float()
    n_out = delta / d[:, None]
    e = [hb[i] - cl[i].abs() for i in range(3)]
    emin = torch.minimum(e[0], torch.minimum(e[1], e[2]))
    is0 = ((e[0] <= e[1]) & (e[0] <= e[2])).float()
    is1 = (1.0 - is0) * (e[1] <= e[2]).float()
    is2 = 1.0 - is0 - is1
    n_in = torch.stack([is0 * _sign(cl[0]), is1 * _sign(cl[1]),
                        is2 * _sign(cl[2])], -1)
    n_local = n_out * outside[:, None] + n_in * (1.0 - outside[:, None])
    pen = (radius - d) * outside + (radius + emin) * (1.0 - outside)
    n = mat3vec(Rb, n_local)
    r = radius[:, None] if torch.is_tensor(radius) else radius
    return [_mk_lane(c - n * r, n, pen, (pen > -1e-4).float(), mu, **meta)]


def build_lanes(sc: D.SceneConsts, ch, bp, bq, Ra):
    """All contact lanes of one substep, in the order of
    `pallas_engine.py:573-611`. The arm spheres see the cylinder as the box
    of its half extents, as both reference engines do."""
    fpos, r7 = ch['fpos'], ch['r7']
    Rb7 = qmat(r7)
    fhalf = sc.finger.half
    lanes = []
    pad = dict(body_sgn=1.0, fin_sgn=-1.0, link=6, arm_sgn=-1.0, ee_sgn=-1.0)
    if sc.has_body and sc.geom_type == S.BOX:
        lanes += box_plane_lanes(bp, bq, sc.half, sc.plane_z, sc.plane_mu,
                                 body_sgn=1.0)
        for f in range(2):
            lanes += sat_box_box_lanes(
                bp, Ra, sc.half, fpos[:, f], Rb7, fhalf, sc.finger_mu,
                finger_idx=f, **pad)
    elif sc.has_body:
        # the puck: radius half[0], half length half[2]; the pad is side B
        lanes += cyl_plane_lanes(bp, bq, sc.half[0], sc.half[2], sc.plane_z,
                                 sc.plane_mu, body_sgn=1.0)
        for f in range(2):
            lanes += box_cyl_lanes(
                fpos[:, f], Rb7, fhalf, bp, sc.half[0], sc.half[2],
                sc.finger_mu, finger_idx=f, **pad)
    for f in range(2):
        lanes += box_plane_lanes(
            fpos[:, f], r7, fhalf, sc.plane_z, 1.0 * sc.plane_friction,
            finger_idx=f, fin_sgn=1.0, link=6, arm_sgn=1.0, couple=1.0,
            ee_sgn=1.0)
    # arm spheres the workspace envelope can never bring into contact are
    # culled (ops/lane_cull.py)
    for sp in range(D.N_ARM_SPHERES):
        link = int(KM.ARM_SPHERE_LINK[sp])
        radius = float(np.float32(KM.ARM_SPHERE_RADIUS[sp]))
        ee = 1.0 if link == 6 else 0.0
        c = ch['spheres'][:, sp]
        if sc.plane_mask >> sp & 1:
            lanes += sphere_plane_lane(c, radius, sc.plane_z,
                                       0.5 * sc.plane_friction, link=link,
                                       arm_sgn=1.0, couple=1.0, ee_sgn=ee)
        if sc.has_body and sc.geom_mask >> sp & 1:
            lanes += sphere_box_lane(c, radius, bp, Ra, sc.half,
                                     0.5 * sc.body_friction, body_sgn=-1.0,
                                     link=link, arm_sgn=1.0, couple=1.0,
                                     ee_sgn=ee)
    return lanes


_META = {}


def lane_meta(lanes, like):
    """Static per-lane metadata as (L,) tensors, cached per lane plan and
    device, plus the group bounds: lanes [n_link:] carry an arm point
    velocity, lanes [n_cpl:] let the arm yield."""
    key = (tuple(tuple(l[4:]) for l in lanes), like.device)
    m = _META.get(key)
    if m is not None:
        return m
    L = len(lanes)
    n_link = next((i for i, l in enumerate(lanes) if l.link >= 0), L)
    n_cpl = next((i for i, l in enumerate(lanes) if l.couple > 0), L)
    assert all(l.link >= 0 for l in lanes[n_link:])
    assert all(l.couple > 0 and l.arm_sgn == 1.0 for l in lanes[n_cpl:])
    assert all(l.couple == 0 for l in lanes[:n_cpl])

    def t(vals):
        return torch.tensor(vals, dtype=like.dtype, device=like.device)

    m = dict(
        L=L, n_link=n_link, n_cpl=n_cpl,
        mu=t([l.mu for l in lanes]),
        body_sgn=t([l.body_sgn for l in lanes]),
        body_in=t([abs(l.body_sgn) for l in lanes]),
        is_fin=[t([1.0 if l.finger_idx == f else 0.0 for l in lanes])
                for f in range(2)],
        fin_sgn=t([l.fin_sgn for l in lanes]),
        arm_sgn=t([l.arm_sgn for l in lanes]),
        ee_sgn=t([l.ee_sgn for l in lanes]),
        jmask_l=[t([1.0 if l.link >= j else 0.0 for l in lanes[n_link:]])
                 for j in range(7)],
        jmask_c=[t([1.0 if l.link >= j else 0.0 for l in lanes[n_cpl:]])
                 for j in range(7)],
        arm_sgn_l=t([l.arm_sgn for l in lanes[n_link:]]))
    _META[key] = m
    return m


# ---------------------------------------------------------------- substep
def substep(sc: D.SceneConsts, carry, qt, ft):
    """One velocity-level 2 ms substep (`pallas_engine.py:substep`): servos
    and gravity propose velocities, contacts generated at the CURRENT
    coordinates correct them (with frozen-arm joint coupling), then all
    coordinates integrate together. Returns (carry, ee_force)."""
    q, qd, fq, fqd, bp, bq, bv, bw = carry
    dt = D.DT_SUB
    has_body = sc.has_body
    fc = sc.finger

    # 1. arm servo -> proposed qd (q integrates after the solve)
    v_des = torch.clamp(D.ARM_SERVO_RATE * (qt - q), -D.ARM_VEL_LIMIT,
                        D.ARM_VEL_LIMIT)
    dv = const(_ARM_DV, q)
    qd = qd + torch.clamp(v_des - qd, -dv, dv)

    # 2. FK at the current configuration
    ch = fk_chain(q, fq, sc.gripper)
    o, z = ch['o'], ch['z']

    # 3. finger servo
    fv_des = torch.clamp(D.ARM_SERVO_RATE * (ft - fq), -fc.vel_limit,
                         fc.vel_limit)
    fdv = fc.force * dt / fc.mass
    fqd = fqd + torch.clamp(fv_des - fqd, -fdv, fdv)

    # 4. gravity
    Ra = None
    if has_body:
        bv = torch.stack([bv[:, 0], bv[:, 1], bv[:, 2] - D.GRAVITY * dt], -1)
        Ra = qmat(bq)

    # 5. contacts
    lanes = build_lanes(sc, ch, bp, bq, Ra)
    m = lane_meta(lanes, q)
    L, n_link, n_cpl = m['L'], m['n_link'], m['n_cpl']
    pts = torch.stack([l.pt for l in lanes], 1)           # (N, L, 3)
    nrm = torch.stack([l.nrm for l in lanes], 1)
    pen = torch.stack([l.pen for l in lanes], 1)          # (N, L)
    act = torch.stack([l.active for l in lanes], 1)
    is_fin, is_fin_v = m['is_fin'], [x[:, None] for x in m['is_fin']]
    body_sgn_v = m['body_sgn'][:, None]
    fin_sgn_v = m['fin_sgn'][:, None]

    # 6. solve (fused Jacobi with mass splitting)
    if has_body:
        ii = sc.inv_inertia
        inv_I_w = torch.stack([torch.stack([
            sum(Ra[:, i, j] * ii[j] * Ra[:, k, j] for j in range(3))
            for k in range(3)], -1) for i in range(3)], -2)   # (N, 3, 3)
        r_a = pts - bp[:, None]
    # tangent frame
    up = torch.where(nrm[..., 2:3].abs() < 0.9, const(_EZ, nrm),
                     const([1.0, 0.0, 0.0], nrm))
    t1 = vcross(nrm, up)
    t1 = t1 * torch.rsqrt((t1 * t1).sum(-1, keepdim=True).clamp_min(1e-18))
    t2 = vcross(nrm, t1)

    body_count = (act * m['body_in']).sum(1).clamp_min(1.0)
    fin_count = [(act * is_fin[f]).sum(1).clamp_min(1.0) for f in range(2)]
    arm_count = act[:, n_cpl:].sum(1).clamp_min(1.0) if n_cpl < L else None

    faxis = ch['faxis']
    lane_axis = (faxis[:, 0, None] * is_fin_v[0]
                 + faxis[:, 1, None] * is_fin_v[1])           # (N, L, 3)
    lane_fin_count = (fin_count[0][:, None] * is_fin[0]
                      + fin_count[1][:, None] * is_fin[1]
                      + (1.0 - is_fin[0] - is_fin[1]))

    # frozen arm point velocity v_arm(p) = sum_j qd_j (z_j x (p - o_j)) on
    # the link>=0 lane tail; J_j . d is computed as z_j . ((p - o_j) x d)
    N = q.shape[0]
    if n_link < L:
        pts_l = pts[:, n_link:]
        v_tail = 0.0
        for j in range(7):
            zx = vcross(z[:, j, None].expand(pts_l.shape),
                        pts_l - o[:, j, None])
            v_tail = v_tail + zx * qd[:, j, None, None] \
                * m['jmask_l'][j][:, None]
        v_arm = torch.cat([pts.new_zeros((N, n_link, 3)), v_tail], 1)
    else:
        v_arm = torch.zeros_like(pts)

    def k_arm(d):
        """Arm effective inverse mass along d, on the couple=1 tail only."""
        if n_cpl >= L:
            return 0.0
        pts_c, dc = pts[:, n_cpl:], d[:, n_cpl:]
        k = 0.0
        for j in range(7):
            jd = (vcross(pts_c - o[:, j, None], dc) * z[:, j, None]).sum(-1)
            k = k + jd * jd * float(_INV_ARM_INERTIA[j]) * m['jmask_c'][j]
        k = k * arm_count[:, None]
        return torch.cat([k.new_zeros((N, n_cpl)), k], 1)

    def k_dir(d):
        da = (d * lane_axis).sum(-1)
        k = (da * da / fc.mass) * lane_fin_count * (is_fin[0] + is_fin[1])
        k = k + k_arm(d)
        if has_body:
            rxd = vcross(r_a, d)
            Iw_rxd = torch.stack(
                [sum(inv_I_w[:, i, j, None] * rxd[..., j] for j in range(3))
                 for i in range(3)], -1)
            k = k + ((sc.inv_mass + (rxd * Iw_rxd).sum(-1))
                     * body_count[:, None] * m['body_in'])
        return k

    kn_raw = k_dir(nrm)
    solvable = act * (kn_raw > 1e-8).float()
    kn = kn_raw.clamp_min(1e-8)
    kt1 = k_dir(t1).clamp_min(1e-8)
    kt2 = k_dir(t2).clamp_min(1e-8)
    # capped recovery velocity
    bias = -torch.clamp_max((sc.erp / dt) * (pen - sc.slop).clamp_min(0.0),
                            D.BIAS_CAP)
    solve_on = solvable > 0
    mu = m['mu']

    def point_vel(bv_, bw_, fqd_):
        v_fin_dof = (faxis[:, 0, None] * fqd_[:, 0, None, None] * is_fin_v[0]
                     + faxis[:, 1, None] * fqd_[:, 1, None, None]
                     * is_fin_v[1])
        # signed relative velocity va - vb per lane
        v = v_arm * m['arm_sgn'][:, None] + v_fin_dof * fin_sgn_v
        if has_body:
            v_body = bv_[:, None] + vcross(bw_[:, None].expand(r_a.shape), r_a)
            v = v + v_body * body_sgn_v
        return v

    bv_, bw_, fqd_ = bv, bw, fqd
    ln = lt1 = lt2 = torch.zeros_like(pen)
    for _ in range(sc.solver_iters):
        vrel = point_vel(bv_, bw_, fqd_)
        dln = torch.where(solve_on, -(vdot(vrel, nrm) + bias) / kn, 0.0)
        nln = (ln + dln).clamp_min(0.0)
        dln = nln - ln
        lim = mu * nln
        dlt1 = torch.where(solve_on, -vdot(vrel, t1) / kt1, 0.0)
        nlt1 = torch.clamp(lt1 + dlt1, -lim, lim)
        dlt1 = nlt1 - lt1
        dlt2 = torch.where(solve_on, -vdot(vrel, t2) / kt2, 0.0)
        nlt2 = torch.clamp(lt2 + dlt2, -lim, lim)
        dlt2 = nlt2 - lt2
        imp = nrm * dln[..., None] + t1 * dlt1[..., None] + t2 * dlt2[..., None]
        if has_body:
            imp_b = imp * body_sgn_v
            bv_ = bv_ + imp_b.sum(1) * sc.inv_mass
            bw_ = bw_ + mat3vec(inv_I_w, vcross(r_a, imp_b).sum(1))
        dfq = (imp * lane_axis).sum(-1) * m['fin_sgn'] / fc.mass
        fqd_ = torch.stack([fqd_[:, 0] + (dfq * is_fin[0]).sum(1),
                            fqd_[:, 1] + (dfq * is_fin[1]).sum(1)], -1)
        ln, lt1, lt2 = nln, nlt1, nlt2

    tot_imp = nrm * ln[..., None] + t1 * lt1[..., None] + t2 * lt2[..., None]

    # arm coupling: accumulated impulses -> joint velocities, once after the
    # loop, capped at the motor's per-substep authority
    if n_link < L:
        imp_arm = tot_imp[:, n_link:] * m['arm_sgn_l'][:, None]
        pts_t = pts[:, n_link:]
        new_qd = []
        for j in range(7):
            pd = vcross(pts_t - o[:, j, None], imp_arm)
            jd = ((pd * z[:, j, None]).sum(-1) * m['jmask_l'][j]).sum(1)
            new_qd.append(qd[:, j] + torch.clamp(
                jd * float(_INV_ARM_INERTIA[j]), -_ARM_CAP[j], _ARM_CAP[j]))
        qd = torch.stack(new_qd, -1)

    # EE force sensor: impulse applied onto the gripper / dt
    ee_force = (tot_imp * m['ee_sgn'][:, None]).sum(1) / dt

    # 7. integrate; joints at a hard stop lose the velocity into the stop
    lo, hi = const(_JL_LO, q), const(_JL_HI, q)
    q = torch.clamp(q + qd * dt, lo, hi)
    qd = torch.where((q >= hi) & (qd > 0), 0.0,
                     torch.where((q <= lo) & (qd < 0), 0.0, qd))
    if has_body:
        bp = bp + bv_ * dt
        w_norm = torch.sqrt((bw_ * bw_).sum(-1).clamp_min(1e-18))
        half_ang = w_norm * dt * 0.5
        s = torch.where(w_norm > 1e-9, torch.sin(half_ang) / w_norm, 0.0)
        dq_rot = torch.cat([torch.cos(half_ang)[:, None], bw_ * s[:, None]], -1)
        bq = qnormalize(qmul(dq_rot, bq))
    fq = torch.clamp(fq + fqd_ * dt, fc.lo, fc.hi)
    fqd_ = torch.where((fq >= fc.hi) & (fqd_ > 0), 0.0,
                       torch.where((fq <= fc.lo) & (fqd_ < 0), 0.0, fqd_))
    return (q, qd, fq, fqd_, bp, bq, bv_, bw_), ee_force


def control_step(sc: D.SceneConsts, state: D.PhysicsState,
                 controls: D.Controls,
                 n_substeps: int = D.SIM_CALLS_PER_STEP * D.SUBSTEPS_PER_SIM
                 ) -> D.PhysicsState:
    """``n_substeps`` substeps on a batch (`PallasEngine.control_step`)."""
    carry = (state.q, state.qd, state.fq, state.fqd, state.body_pos[:, 0],
             state.body_quat[:, 0], state.body_linvel[:, 0],
             state.body_angvel[:, 0])
    ee = torch.zeros_like(state.ee_contact_force)
    for _ in range(n_substeps):
        carry, ee = substep(sc, carry, controls.q_target, controls.f_target)
    q, qd, fq, fqd, bp, bq, bv, bw = carry
    return D.PhysicsState(
        q=q, qd=qd, fq=fq, fqd=fqd, body_pos=bp[:, None],
        body_quat=bq[:, None], body_linvel=bv[:, None],
        body_angvel=bw[:, None], door_q=state.door_q, door_qd=state.door_qd,
        ee_contact_force=ee)
