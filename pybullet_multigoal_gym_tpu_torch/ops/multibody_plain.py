"""Plain PyTorch version of kernel K3: the fused control step of scenes with
several free bodies.

Counterpart of `pybullet_multigoal_gym_tpu/ops/pallas_multibody.py`
(`_build_kernel`'s ``substep``, `:336-852`) for scenes of free and pinned
bodies made of box geoms of any size, static boxes and a prismatic door,
with the parallel-jaw gripper (block_stack, block_rearrange, the chest
tasks, the push primitives and insertion) or the Robotiq-85 (the block
tasks), written over a leading env axis:
bodies stack on axis 1 of the state, and contact lanes on axis 1 of the
lane tensors. The lane order, the lane frictions and the side metadata are
those of the Pallas kernel (`:398-517`): per free body, per geom of it, the
plane (4), the two fingers (2 x 9), then per static box, per geom of a
pinned body and per door panel a one-sided manifold (5) and the edge-edge
candidate; then per geom of a pinned body the two fingers (2 x 9); then per
pair of free bodies, per pair of their geoms, 9 + the edge-edge candidate;
then per finger, per door panel, a two-sided manifold (9) with the door as
side A; then per finger its pad on the plane (4) and against each static
box (one-sided, 5); then the arm-sphere lanes that `ops/lane_cull.py` keeps
(per sphere, the plane, then each geom, static box and door panel it
reaches). Every lane of a geom acts on its body: the solve, the mass
splitting and the coupling are per body. A lane's sides are ('body', b),
('pinned', b), ('static', s), ('door',), ('finger', f), ('arm', sphere) or
('world',); its arm link, arm sign, arm coupling and EE-sensor sign follow
from them (`pallas_multibody.py:68-107`). A pinned or static side acts as
the world does (no velocity, no share of an impulse), where the Pallas
kernel names it ('pinned',) on side A and ('world',) on side B; its own
name keeps its lanes' groups apart. A pinned body gets no gravity and no
integration: its pose and velocities pass through. The door is a side with
one degree of freedom: its point velocity is ``door_axis * door_qd``, its
share of a lane's effective mass ``(d . axis)^2 / m_door`` times its count of
active lanes, and it takes its lanes' impulses along its axis; before the
contacts a servo drives it toward its hold-open target (or it coasts), and
it integrates clamped to [0, limit].

The CPU path and the tests run this module; on the card
`ops/cuda_multibody.py` launches `csrc/multibody.cu` instead, and the chip
smoke test holds the two against each other.
"""

import functools
from typing import NamedTuple

import numpy as np
import torch

from pybullet_multigoal_gym_tpu_torch.model import kuka_model as KM
from pybullet_multigoal_gym_tpu_torch.ops import dynamics as D
from pybullet_multigoal_gym_tpu_torch.ops import engine_plain as EP
from pybullet_multigoal_gym_tpu_torch.utils.tensors import const, index

vcross, vdot, qmat, qmul = EP.vcross, EP.vdot, EP.qmat, EP.qmul


class LaneSpec(NamedTuple):
    """The static part of one contact lane (`pallas_multibody.py:_Lane`):
    its friction and its two sides; the normal points from side B toward
    side A."""
    mu: float
    side_a: tuple
    side_b: tuple


def lane_link(sa, sb):
    """Arm joints 0..link carry the lane's arm side (-1: none)."""
    if sa[0] == 'arm':
        return int(KM.ARM_SPHERE_LINK[sa[1]])
    return 6 if 'finger' in (sa[0], sb[0]) else -1


def arm_sgn(sa, sb):
    if sa[0] in ('arm', 'finger'):
        return 1.0
    return -1.0 if sb[0] == 'finger' else 0.0


def couple(sa, sb):
    """1 where the arm yields in the solve: arm spheres and finger-vs-world
    lanes (the plane, a static box)."""
    return 1.0 if sa[0] == 'arm' or (sa[0] == 'finger' and
                                     sb[0] in ('world', 'static')) else 0.0


def ee_sgn(sa, sb):
    """Sign of the lane's share of the EE force sensor."""
    if sa[0] == 'finger':
        return 1.0
    if sa[0] == 'arm' and int(KM.ARM_SPHERE_LINK[sa[1]]) == 6:
        return 1.0
    return -1.0 if sb[0] == 'finger' else 0.0


def lane_group(spec: LaneSpec):
    """The contact-lane group of a lane, from its sides."""
    ka, kb = spec.side_a[0], spec.side_b[0]
    if ka == 'body':
        return {'world': 'box-plane', 'finger': 'finger-box',
                'body': 'box-box', 'pinned': 'box-pinned',
                'static': 'box-static', 'door': 'box-door'}[kb]
    if ka in ('pinned', 'door'):
        return 'finger-' + ka
    if ka == 'finger':
        return 'finger-static' if kb == 'static' else 'finger-plane'
    return {'world': 'sphere-plane', 'body': 'sphere-box',
            'pinned': 'sphere-pinned', 'static': 'sphere-static',
            'door': 'sphere-door'}[kb]


def _body_side(sc: D.MultiBodyConsts, b):
    return ('pinned' if sc.pinned[b] else 'body', b)


def _sphere_lanes(sc: D.MultiBodyConsts):
    """The kept arm-sphere lanes in the kernel's order, as (sphere, kind,
    item): ('plane', -1), ('geom', g), ('static', s), ('door', panel)."""
    out = []
    for sp in range(D.N_ARM_SPHERES):
        if sc.plane_mask >> sp & 1:
            out.append((sp, 'plane', -1))
        out += [(sp, 'geom', g) for g in sc.geom_order
                if sc.geom_mask[g] >> sp & 1]
        out += [(sp, 'static', s) for s in range(sc.ns)
                if sc.static_mask[s] >> sp & 1]
        if sc.door_mask >> sp & 1:
            out += [(sp, 'door', d) for d in range(sc.nd)]
    return out


def lane_plan(sc: D.MultiBodyConsts):
    """Every lane's `LaneSpec`, in the kernel's order."""
    plan, gb = [], sc.geom_body
    for g in sc.free_geoms:
        b = gb[g]
        plan += [LaneSpec(sc.mu_plane(b), ('body', b), ('world',))] * 4
        for f in range(2):
            plan += [LaneSpec(sc.mu_finger(b), ('body', b), ('finger', f))] * 9
        for s in range(sc.ns):
            plan += [LaneSpec(sc.mu_static(b, s), ('body', b),
                              ('static', s))] * 6
        for g2 in sc.pinned_geoms:
            plan += [LaneSpec(sc.mu_pair(b, gb[g2]), ('body', b),
                              ('pinned', gb[g2]))] * 6
        plan += [LaneSpec(sc.mu_door(b), ('body', b), ('door',))] * 6 * sc.nd
    for g2 in sc.pinned_geoms:
        for f in range(2):
            plan += [LaneSpec(sc.mu_finger(gb[g2]), ('pinned', gb[g2]),
                              ('finger', f))] * 9
    for g, g2 in sc.geom_pairs:
        b, b2 = gb[g], gb[g2]
        plan += [LaneSpec(sc.mu_pair(b, b2), ('body', b), ('body', b2))] * 10
    for f in range(2):
        plan += [LaneSpec(sc.mu_finger_door, ('door',), ('finger', f))] * (
            9 * sc.nd)
    for f in range(2):
        plan += [LaneSpec(sc.mu_finger_plane, ('finger', f), ('world',))] * 4
        for s in range(sc.ns):
            plan += [LaneSpec(sc.mu_finger_static(s), ('finger', f),
                              ('static', s))] * 5
    for sp, kind, k in _sphere_lanes(sc):
        if kind == 'plane':
            plan.append(LaneSpec(sc.mu_sphere_plane, ('arm', sp), ('world',)))
        elif kind == 'geom':
            plan.append(LaneSpec(sc.mu_sphere(gb[k]), ('arm', sp),
                                 _body_side(sc, gb[k])))
        elif kind == 'static':
            plan.append(LaneSpec(sc.mu_sphere_static(k), ('arm', sp),
                                 ('static', k)))
        else:
            plan.append(LaneSpec(sc.mu_sphere_door, ('arm', sp), ('door',)))
    return plan


def _stack(lanes, rows):
    """Lanes computed for ``rows`` x k items at once (item-major) -> (rows,
    k x lanes per item) lane tensors: the lanes of item 0 first."""
    out = []
    for f in ('pt', 'nrm', 'pen', 'active'):
        x = torch.stack([getattr(l, f) for l in lanes], 1)
        out.append(x.reshape((rows, -1) + x.shape[2:]))
    return out


@functools.lru_cache(maxsize=None)
def _plan_positions(sc: D.MultiBodyConsts):
    """Where each item's lanes start in `lane_plan`: ('geom', g) (a free
    geom's plane and fingers), ('static', g, s), ('pinned', g, g2) and
    ('door', g, d) (free geom g against static s, pinned geom g2, door panel
    d), ('fingers', g2) (pinned geom g2 against the fingers), ('pair', (g,
    g2)), ('fdoor', f, d) (finger f against door panel d), ('pad', f) and
    ('fstatic', f, s) (finger f's pad on the plane, against static s), and
    per sphere sp ('plane', sp), ('sphere', sp, g), ('sstatic', sp, s) and
    ('sdoor', sp, d)."""
    pos, at = {}, 0
    for g in sc.free_geoms:
        pos['geom', g] = at
        at += 22
        for s in range(sc.ns):
            pos['static', g, s] = at
            at += 6
        for g2 in sc.pinned_geoms:
            pos['pinned', g, g2] = at
            at += 6
        for d in range(sc.nd):
            pos['door', g, d] = at
            at += 6
    for g2 in sc.pinned_geoms:
        pos['fingers', g2] = at
        at += 18
    for p in sc.geom_pairs:
        pos['pair', p] = at
        at += 10
    for f in range(2):
        for d in range(sc.nd):
            pos['fdoor', f, d] = at
            at += 9
    for f in range(2):
        pos['pad', f] = at
        at += 4
        for s in range(sc.ns):
            pos['fstatic', f, s] = at
            at += 5
    names = dict(plane='plane', geom='sphere', static='sstatic', door='sdoor')
    for sp, kind, k in _sphere_lanes(sc):
        pos[(names[kind], sp) + ((k,) if kind != 'plane' else ())] = at
        at += 1
    return pos


def _by_size(items, size):
    """``items`` grouped by ``size(item)``, each group in item order."""
    groups = {}
    for i in items:
        groups.setdefault(size(i), []).append(i)
    return groups.items()


def build_lanes(sc: D.MultiBodyConsts, ch, bp, bq, R, door_q=None):
    """All contact lanes of one substep in the kernel's order (`lane_plan`),
    as (N, L, 3) points and normals and (N, L) penetrations and 0/1
    activations. ``bp`` (N, NB, 3), ``bq`` (N, NB, 4) and ``R`` (N, NB, 3,
    3) are the bodies' positions, orientations and rotation matrices, and
    ``door_q`` (N,) the door's joint value (a scene with a door needs it). A
    geom's centre is its body's position plus R times its offset
    (`pallas_multibody.py:393-397`); a door panel's the door frame's
    position plus its offset (`:384-387`). The lanes of one kind are
    computed for all geoms, geom pairs, fingers or sphere-geom pairs of one
    size at once, then put in plan order."""
    N = bp.shape[0]
    fhalf = sc.finger.half
    fpos, r7 = ch['fpos'], ch['r7']
    Rb7 = qmat(r7)
    gb, half = sc.geom_body, sc.geom_half
    pos = _plan_positions(sc)

    def flat(x):
        return x.reshape((-1,) + x.shape[2:])

    def rep(x, k):                 # (M, ...) -> (M * k, ...), each k times
        return flat(x[:, None].expand((x.shape[0], k) + x.shape[1:]))

    centre = {}
    for g in range(sc.ng):
        c = bp[:, gb[g]]
        if any(sc.geom_pos[g]):
            c = c + _mat3vec(R[:, gb[g]], const(sc.geom_pos[g], c))
        centre[g] = c

    def geoms(sel):
        """Centres, rotation matrices and orientations of geoms ``sel``,
        (N x len(sel), ...), geom-major within each env."""
        bs = index([gb[g] for g in sel], R)
        return (flat(torch.stack([centre[g] for g in sel], 1)),
                flat(R[:, bs]), flat(bq[:, bs]))

    blocks, order = [], []       # lane tensors, and their lanes' plan places

    def add(fields, places):
        blocks.append([x.reshape((N, -1) + x.shape[2:]) for x in fields])
        order.extend(places)

    def finger_lanes(c, Rg, h, k):
        """Geoms (N x k) against finger 0, then finger 1 (9 lanes each)."""
        return _stack(EP.sat_box_box_lanes(
            rep(c, 2), rep(Rg, 2), h, flat(rep(fpos, k)),
            rep(rep(Rb7, k), 2), fhalf, 0.0), N * k)

    # the world boxes: static s and door panel d, each (N, 3) centres with
    # the identity rotation
    eye = const(np.eye(3), bp)
    world = {('static', s): const(sc.static_pos[s], bp).expand(N, 3)
             for s in range(sc.ns)}
    if sc.nd:
        dpos = sc.door_frame(door_q)[0]
        world.update({('door', d): dpos + const(sc.door_pos[d], bp)
                      for d in range(sc.nd)})
    whalf = {('static', s): sc.static_half[s] for s in range(sc.ns)}
    whalf.update({('door', d): sc.door_half[d] for d in range(sc.nd)})

    def boxes(sel):
        """Centres of world boxes ``sel``, (N, len(sel), 3)."""
        return torch.stack([world[w] for w in sel], 1)

    def cross_items(a, b):
        """Rows (N, k, ...) and (N, m, ...) -> every (k, m) pair, (N x k x
        m, ...), env-major, then a's items, then b's."""
        k, m = a.shape[1], b.shape[1]
        return (a[:, :, None].expand((N, k, m) + a.shape[2:])
                .reshape((-1,) + a.shape[2:]),
                b[:, None].expand((N, k, m) + b.shape[2:])
                .reshape((-1,) + b.shape[2:]))

    # per free geom: the plane (4), then finger 0 and finger 1 (9 each),
    # then each static box, pinned geom and door panel (one-sided 5 and the
    # edge lane)
    for h, sel in _by_size(sc.free_geoms, lambda g: half[g]):
        c, Rg, q = geoms(sel)
        k = len(sel)
        plane = _stack(EP.box_plane_lanes(c, q, h, sc.plane_z, 0.0), N * k)
        add([torch.cat([a, b], 1)
             for a, b in zip(plane, finger_lanes(c, Rg, h, k))],
            [pos['geom', g] + j for g in sel for j in range(22)])
        for g2 in sc.pinned_geoms:
            cb, Rb, _ = geoms([g2] * k)
            args = (c, Rg, h, cb, Rb, half[g2], 0.0)
            add(_stack(EP.sat_box_box_lanes(*args, one_sided=True)
                       + EP.edge_lane(*args), N * k),
                [pos['pinned', g, g2] + j for g in sel for j in range(6)])
        # the world boxes of one size at once: geom-major, box-minor
        for hw, ws in _by_size(list(whalf), whalf.__getitem__):
            m = len(ws)
            ca, cb = cross_items(c.reshape(N, k, 3), boxes(ws))
            Ra = cross_items(Rg.reshape(N, k, 3, 3), boxes(ws))[0]
            args = (ca, Ra, h, cb, eye.expand(N * k * m, 3, 3), hw, 0.0)
            add(_stack(EP.sat_box_box_lanes(*args, one_sided=True)
                       + EP.edge_lane(*args), N * k * m),
                [pos[w[:1] + (g,) + w[1:]] + j for g in sel for w in ws
                 for j in range(6)])
    # per pinned geom: finger 0 and finger 1 (9 each), the geom as side A
    for h, sel in _by_size(sc.pinned_geoms, lambda g: half[g]):
        c, Rg, _ = geoms(sel)
        add(finger_lanes(c, Rg, h, len(sel)),
            [pos['fingers', g] + j for g in sel for j in range(18)])
    # per geom pair of two bodies: the SAT manifold and the edge lane
    for (ha, hb), sel in _by_size(sc.geom_pairs,
                                  lambda p: (half[p[0]], half[p[1]])):
        ca, Ra, _ = geoms([g for g, _ in sel])
        cb, Rb, _ = geoms([g2 for _, g2 in sel])
        args = (ca, Ra, ha, cb, Rb, hb, 0.0)
        add(_stack(EP.sat_box_box_lanes(*args) + EP.edge_lane(*args),
                   N * len(sel)),
            [pos['pair', p] + j for p in sel for j in range(10)])
    # per finger, per door panel: the two-sided manifold, the panel as side
    # A (the panels of one size at once, finger-major)
    rot7 = Rb7[:, None].expand(N, 2, 3, 3)
    for hw, ws in _by_size([w for w in whalf if w[0] == 'door'],
                           whalf.__getitem__):
        m = len(ws)
        pf, cb = cross_items(fpos, boxes(ws))
        add(_stack(EP.sat_box_box_lanes(
            cb, eye.expand(N * 2 * m, 3, 3), hw, pf,
            cross_items(rot7, boxes(ws))[0], fhalf, 0.0), N * 2 * m),
            [pos['fdoor', f, w[1]] + j for f in range(2) for w in ws
             for j in range(9)])
    add(_stack(EP.box_plane_lanes(flat(fpos), rep(r7, 2), fhalf, sc.plane_z,
                                  0.0), N),
        [pos['pad', f] + j for f in range(2) for j in range(4)])
    # per finger, per static box: the pad's one-sided manifold (5)
    for hw, ws in _by_size([w for w in whalf if w[0] == 'static'],
                           whalf.__getitem__):
        m = len(ws)
        pf, cb = cross_items(fpos, boxes(ws))
        add(_stack(EP.sat_box_box_lanes(
            pf, cross_items(rot7, boxes(ws))[0], fhalf, cb,
            eye.expand(N * 2 * m, 3, 3), hw, 0.0, one_sided=True), N * 2 * m),
            [pos['fstatic', f, w[1]] + j for f in range(2) for w in ws
             for j in range(5)])
    radius = [float(np.float32(r)) for r in KM.ARM_SPHERE_RADIUS]
    spheres = ch['spheres']
    for sp in range(D.N_ARM_SPHERES):
        if sc.plane_mask >> sp & 1:
            add(_stack(EP.sphere_plane_lane(spheres[:, sp], radius[sp],
                                            sc.plane_z, 0.0), N),
                [pos['plane', sp]])
    # every kept sphere-geom pair of one geom size at once
    for h, sel in _by_size([(sp, k) for sp, kind, k in _sphere_lanes(sc)
                            if kind == 'geom'], lambda p: half[p[1]]):
        sps = [sp for sp, _ in sel]
        cg, Rg, _ = geoms([g for _, g in sel])
        r = const([radius[sp] for sp in sps], cg)
        add(_stack(EP.sphere_box_lane(flat(spheres[:, index(sps, cg)]),
                                      r.expand(N, len(sel)).reshape(-1),
                                      cg, Rg, h, 0.0), N * len(sel)),
            [pos['sphere', sp, g] for sp, g in sel])
    # and every kept sphere-world box pair of one box size
    for hw, sel in _by_size([(sp, (kind, k)) for sp, kind, k in
                             _sphere_lanes(sc) if kind in ('static', 'door')],
                            lambda p: whalf[p[1]]):
        sps = [sp for sp, _ in sel]
        r = const([radius[sp] for sp in sps], bp)
        add(_stack(EP.sphere_box_lane(
            flat(spheres[:, index(sps, bp)]),
            r.expand(N, len(sel)).reshape(-1),
            flat(boxes([w for _, w in sel])),
            eye.expand(N * len(sel), 3, 3), hw, 0.0), N * len(sel)),
            [pos['s' + w[0], sp, w[1]] for sp, w in sel])
    out = [torch.cat([b[f] for b in blocks], 1) for f in range(4)]
    if order == sorted(order):
        return out
    key = (sc, bp.device)
    perm = _PERM.get(key)
    if perm is None:
        perm = _PERM[key] = torch.as_tensor(np.argsort(order),
                                            device=bp.device)
    return [x[:, perm] for x in out]


_PERM = {}      # per scene and device: build_lanes' order -> plan order


_META = {}


def lane_meta(sc: D.MultiBodyConsts, like):
    """Static per-lane metadata of `lane_plan` as tensors on ``like``'s
    device (cached): which body and finger each side is, the arm link mask
    per joint, the signs and the frictions."""
    key = (sc, like.device)
    m = _META.get(key)
    if m is not None:
        return m

    def t(vals, dtype=like.dtype):
        return torch.tensor(vals, dtype=dtype, device=like.device)

    plan = lane_plan(sc)
    sides = [(l.side_a, l.side_b) for l in plan]
    body_a = [sa[1] if sa[0] == 'body' else -1 for sa, _ in sides]
    body_b = [sb[1] if sb[0] == 'body' else -1 for _, sb in sides]
    fin_a = [sa[1] if sa[0] == 'finger' else -1 for sa, _ in sides]
    fin_b = [sb[1] if sb[0] == 'finger' else -1 for _, sb in sides]
    link = [lane_link(sa, sb) for sa, sb in sides]
    cpl = [couple(sa, sb) for sa, sb in sides]
    m = dict(
        L=len(plan), mu=t([l.mu for l in plan]),
        # gather indices (a lane without a body side reads body 0 and masks
        # it out) and the masks of each side's kind
        ia=t([max(b, 0) for b in body_a], torch.long),
        ib=t([max(b, 0) for b in body_b], torch.long),
        has_a=t([b >= 0 for b in body_a], torch.bool),
        has_b=t([b >= 0 for b in body_b], torch.bool),
        fin=t([max(fa, fb, 0) for fa, fb in zip(fin_a, fin_b)], torch.long),
        fin_a=t([f >= 0 for f in fin_a], torch.bool),
        fin_b=t([f >= 0 for f in fin_b], torch.bool),
        arm_a=t([sa[0] == 'arm' for sa, _ in sides], torch.bool),
        # per body b: the lanes that touch it, on either side, on side A,
        # on side B
        body_in=t([[1.0 if b in (ba, bb) else 0.0 for b in range(sc.nb)]
                   for ba, bb in zip(body_a, body_b)]),
        on_a=t([[1.0 if ba == b else 0.0 for b in range(sc.nb)]
                for ba in body_a]),
        on_b=t([[1.0 if bb == b else 0.0 for b in range(sc.nb)]
                for bb in body_b]),
        # per finger f: +1 where side A is f, -1 where side B is f
        fin_sgn=t([[1.0 if fa == f else (-1.0 if fb == f else 0.0)
                    for f in range(2)] for fa, fb in zip(fin_a, fin_b)]),
        # the door: +1 where it is side A, -1 where side B
        door_a=t([sa == ('door',) for sa, _ in sides], torch.bool),
        door_b=t([sb == ('door',) for _, sb in sides], torch.bool),
        door_sgn=t([1.0 if sa == ('door',) else
                    (-1.0 if sb == ('door',) else 0.0) for sa, sb in sides]),
        fin_any=t([[1.0 if f in (fa, fb) else 0.0 for f in range(2)]
                   for fa, fb in zip(fin_a, fin_b)]),
        cpl=t(cpl), cpl_on=t([c > 0 for c in cpl], torch.bool),
        jmask=[t([1.0 if lk >= j else 0.0 for lk in link]) for j in range(7)],
        arm_sgn=t([arm_sgn(sa, sb) for sa, sb in sides]),
        ee_sgn=t([ee_sgn(sa, sb) for sa, sb in sides]),
        inv_mass=t(list(sc.inv_mass)),
        inv_inertia=t([list(x) for x in sc.inv_inertia]),
        # per body, pinned: (NB, 1), None where the scene has none
        pinned=t(sc.pinned, torch.bool)[:, None] if any(sc.pinned) else None)
    _META[key] = m
    return m


def _mat3vec(R, v):
    """R (..., 3, 3) @ v (..., 3), as sum_j R[i, j] v[j] in j order."""
    return torch.stack([sum(R[..., i, j] * v[..., j] for j in range(3))
                        for i in range(3)], -1)


def substep(sc: D.MultiBodyConsts, carry, qt, ft, door_on=None,
            door_tgt=None):
    """One velocity-level 2 ms substep (`pallas_multibody.py:336-852`):
    servos and gravity propose velocities, contacts generated at the CURRENT
    coordinates correct them (with frozen-arm joint coupling), then all
    coordinates integrate together. ``carry`` holds q, qd, fq, fqd and the
    bodies' (N, NB, k) pos, quat, linvel and angvel, and in a scene with a
    door its (N,) door_q and door_qd, servoed by the (N,) controls
    ``door_on`` and ``door_tgt``. Returns (carry, ee_force)."""
    q, qd, fq, fqd, bp, bq, bv, bw = carry[:8]
    dt = D.DT_SUB
    fc = sc.finger

    # 1. arm servo -> proposed qd (q integrates after the solve)
    v_des = torch.clamp(D.ARM_SERVO_RATE * (qt - q), -D.ARM_VEL_LIMIT,
                        D.ARM_VEL_LIMIT)
    dv = const(EP._ARM_DV, q)
    qd = qd + torch.clamp(v_des - qd, -dv, dv)

    # 2. FK at the current configuration
    ch = EP.fk_chain(q, fq, sc.gripper)
    o, z, faxis = ch['o'], ch['z'], ch['faxis']

    # 3. finger servo
    fv_des = torch.clamp(D.ARM_SERVO_RATE * (ft - fq), -fc.vel_limit,
                         fc.vel_limit)
    fdv = fc.force * dt / fc.mass
    fqd = fqd + torch.clamp(fv_des - fqd, -fdv, fdv)

    # 4. gravity on the free bodies
    m = lane_meta(sc, q)
    pinned = m['pinned']
    bp0, bv0, bw0 = bp, bv, bw
    bv = torch.cat([bv[..., :2], bv[..., 2:] - D.GRAVITY * dt], -1)
    if pinned is not None:
        bv = torch.where(pinned, bv0, bv)
    R = qmat(bq)                                            # (N, NB, 3, 3)

    # 5. the door: servo toward the hold-open target where its motor is on,
    # else a free coast
    door = sc.nd > 0
    if door:
        door_q, door_qd = carry[8:]
        dv_des = torch.clamp(D.ARM_SERVO_RATE * (door_tgt - door_q), -1.0, 1.0)
        ddv = 500.0 * dt * sc.door_inv_mass
        door_qd = torch.where(
            door_on > 0, door_qd + torch.clamp(dv_des - door_qd, -ddv, ddv),
            door_qd * (1.0 - 2.0 * dt))
        axis = const(sc.door_axis, q)

    # 6. contacts
    pts, nrm, pen, act = build_lanes(sc, ch, bp, bq, R,
                                     door_q if door else None)  # (N, L, ...)

    # 7. solve (fused Jacobi with mass splitting)
    ii = m['inv_inertia']
    Iw = torch.stack([torch.stack([
        sum(R[..., i, j] * ii[:, j] * R[..., k, j] for j in range(3))
        for k in range(3)], -1) for i in range(3)], -2)     # (N, NB, 3, 3)
    ia, ib = m['ia'], m['ib']
    has_a, has_b = m['has_a'][:, None], m['has_b'][:, None]
    r_a = pts - bp[:, ia]
    r_b = pts - bp[:, ib]
    # tangent frame
    up = torch.where(nrm[..., 2:3].abs() < 0.9, const(EP._EZ, nrm),
                     const([1.0, 0.0, 0.0], nrm))
    t1 = vcross(nrm, up)
    t1 = t1 * torch.rsqrt((t1 * t1).sum(-1, keepdim=True).clamp_min(1e-18))
    t2 = vcross(nrm, t1)

    # mass-splitting counts: per body, per finger, and of the yielding lanes
    counts = (act[..., None] * m['body_in']).sum(1).clamp_min(1.0)  # (N, NB)
    fin_counts = (act[..., None] * m['fin_any']).sum(1).clamp_min(1.0)
    arm_count = (act * m['cpl']).sum(1).clamp_min(1.0)
    if door:
        door_count = (act * m['door_sgn'].abs()).sum(1).clamp_min(1.0)
    fin = m['fin']
    lane_axis = faxis[:, fin]                                # (N, L, 3)
    lane_fin_count = fin_counts[:, fin]

    # frozen arm point velocity v_arm(p) = sum_j<=link qd_j (z_j x (p - o_j))
    v_arm = 0.0
    for j in range(7):
        zx = vcross(z[:, j, None].expand(pts.shape), pts - o[:, j, None])
        v_arm = v_arm + zx * qd[:, j, None, None] * m['jmask'][j][:, None]

    def body_k(r, idx, d):
        rxd = vcross(r[:, :, None], d)
        Iw_rxd = _mat3vec(Iw[:, idx, None], rxd)
        return ((m['inv_mass'][idx, None] + (rxd * Iw_rxd).sum(-1))
                * counts[:, idx, None])

    def k_of(d):
        """Effective inverse mass of each lane along each direction of d
        (N, L, 3 directions, 3): side A, then side B, then the yielding arm
        (J_j . d = z_j . ((p - o_j) x d))."""
        da = (d * lane_axis[:, :, None]).sum(-1)
        k_fin = (da * da / fc.mass) * lane_fin_count[..., None]
        k_a = k_b = 0.0
        if door:
            dj = vdot(d, axis)
            k_door = (dj * dj * sc.door_inv_mass) * door_count[:, None, None]
            k_a = torch.where(m['door_a'][:, None], k_door, 0.0)
            k_b = torch.where(m['door_b'][:, None], k_door, 0.0)
        k = torch.where(m['has_a'][:, None], body_k(r_a, ia, d),
                        torch.where(m['fin_a'][:, None], k_fin, k_a))
        k = k + torch.where(m['fin_b'][:, None], k_fin,
                            torch.where(m['has_b'][:, None],
                                        body_k(r_b, ib, d), k_b))
        ka = 0.0
        for j in range(7):
            jd = (vcross((pts - o[:, j, None])[:, :, None], d)
                  * z[:, j, None, None]).sum(-1)
            ka = ka + (jd * jd * float(EP._INV_ARM_INERTIA[j])
                       * m['jmask'][j][:, None])
        return k + torch.where(m['cpl_on'][:, None],
                               ka * arm_count[:, None, None], 0.0)

    k3 = k_of(torch.stack([nrm, t1, t2], 2))                # (N, L, 3)
    kn_raw = k3[..., 0]
    # degenerate lanes (the direction moves no DOF) are excluded, not floored
    solve_on = (act * (kn_raw > 1e-8).float()) > 0
    kn, kt1, kt2 = k3.clamp_min(1e-8).unbind(-1)
    # capped recovery velocity
    bias = -torch.clamp_max((sc.erp / dt) * (pen - sc.slop).clamp_min(0.0),
                            D.BIAS_CAP)
    mu = m['mu']

    def point_vel(bv_, bw_, fqd_, door_qd_):
        """Relative velocity va - vb of each lane's two sides."""
        v_fin = v_arm + lane_axis * fqd_[:, fin, None]
        v_a = v_b = 0.0
        if door:
            v_door = axis * door_qd_[:, None, None]
            v_a = torch.where(m['door_a'][:, None], v_door, 0.0)
            v_b = torch.where(m['door_b'][:, None], v_door, 0.0)
        va = torch.where(has_a, bv_[:, ia] + vcross(bw_[:, ia], r_a),
                         torch.where(m['fin_a'][:, None], v_fin,
                                     torch.where(m['arm_a'][:, None], v_arm,
                                                 v_a)))
        vb = torch.where(m['fin_b'][:, None], v_fin,
                         torch.where(has_b, bv_[:, ib] + vcross(bw_[:, ib], r_b),
                                     v_b))
        return va - vb

    on_a, on_b = m['on_a'][None, :, :, None], m['on_b'][None, :, :, None]
    inv_mass = m['inv_mass'][None, :, None]
    bv_, bw_, fqd_ = bv, bw, fqd
    door_qd_ = door_qd if door else None
    ln = lt1 = lt2 = torch.zeros_like(pen)
    for _ in range(sc.solver_iters):
        vrel = point_vel(bv_, bw_, fqd_, door_qd_)
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
        # side A gains the impulse, side B loses it
        imp4 = imp[:, :, None]
        dv_ = (imp4 * on_a).sum(1) - (imp4 * on_b).sum(1)          # (N, NB, 3)
        dw_ = ((vcross(r_a, imp)[:, :, None] * on_a).sum(1)
               - (vcross(r_b, imp)[:, :, None] * on_b).sum(1))
        bv_ = bv_ + dv_ * inv_mass
        bw_ = bw_ + _mat3vec(Iw, dw_)
        dfq = torch.stack([(vdot(imp, faxis[:, f, None]) * m['fin_sgn'][:, f]
                            ).sum(1) for f in range(2)], -1)
        fqd_ = fqd_ + dfq / fc.mass
        if door:
            # side A gains the impulse along the axis, side B loses it
            ddoor = (vdot(imp, axis) * m['door_sgn']).sum(1)
            door_qd_ = door_qd_ + ddoor * sc.door_inv_mass
        ln, lt1, lt2 = nln, nlt1, nlt2

    tot_imp = nrm * ln[..., None] + t1 * lt1[..., None] + t2 * lt2[..., None]

    # arm coupling: accumulated impulses -> joint velocities, once after the
    # loop, capped at the motor's per-substep authority
    imp_arm = tot_imp * m['arm_sgn'][:, None]
    new_qd = []
    for j in range(7):
        pd = vcross(pts - o[:, j, None], imp_arm)
        jd = ((pd * z[:, j, None]).sum(-1) * m['jmask'][j]).sum(1)
        new_qd.append(qd[:, j] + torch.clamp(
            jd * float(EP._INV_ARM_INERTIA[j]), -EP._ARM_CAP[j], EP._ARM_CAP[j]))
    qd = torch.stack(new_qd, -1)

    # EE force sensor: impulse applied onto the gripper / dt
    ee_force = (tot_imp * m['ee_sgn'][:, None]).sum(1) / dt

    # 8. integrate; joints at a hard stop lose the velocity into the stop
    lo, hi = const(EP._JL_LO, q), const(EP._JL_HI, q)
    q = torch.clamp(q + qd * dt, lo, hi)
    qd = torch.where((q >= hi) & (qd > 0), 0.0,
                     torch.where((q <= lo) & (qd < 0), 0.0, qd))
    bp = bp + bv_ * dt
    w_norm = torch.sqrt((bw_ * bw_).sum(-1).clamp_min(1e-18))
    half_ang = w_norm * dt * 0.5
    s = torch.where(w_norm > 1e-9, torch.sin(half_ang) / w_norm, 0.0)
    dq_rot = torch.cat([torch.cos(half_ang)[..., None], bw_ * s[..., None]], -1)
    bq_new = EP.qnormalize(qmul(dq_rot, bq))
    if pinned is not None:
        # a pinned body's pose and velocities pass through
        bp = torch.where(pinned, bp0, bp)
        bq_new = torch.where(pinned, bq, bq_new)
        bv_ = torch.where(pinned, bv0, bv_)
        bw_ = torch.where(pinned, bw0, bw_)
    bq = bq_new
    fq = torch.clamp(fq + fqd_ * dt, fc.lo, fc.hi)
    fqd_ = torch.where((fq >= fc.hi) & (fqd_ > 0), 0.0,
                       torch.where((fq <= fc.lo) & (fqd_ < 0), 0.0, fqd_))
    out = (q, qd, fq, fqd_, bp, bq, bv_, bw_)
    if door:
        # clamped to [0, limit]; the velocity into a stop is lost
        lim = sc.door_limit
        door_q = torch.clamp(door_q + door_qd_ * dt, 0.0, lim)
        door_qd_ = torch.where((door_q >= lim) & (door_qd_ > 0), 0.0,
                               torch.where((door_q <= 0.0) & (door_qd_ < 0),
                                           0.0, door_qd_))
        out += (door_q, door_qd_)
    return out, ee_force


def carry_of(sc: D.MultiBodyConsts, state: D.PhysicsState):
    """`substep`'s carry of ``state``: the door's two values only in a
    scene with a door."""
    carry = (state.q, state.qd, state.fq, state.fqd, state.body_pos,
             state.body_quat, state.body_linvel, state.body_angvel)
    return carry + ((state.door_q, state.door_qd) if sc.nd else ())


def state_of(state: D.PhysicsState, carry, ee) -> D.PhysicsState:
    """``state`` after `substep`s that ended in ``carry`` and ``ee``."""
    q, qd, fq, fqd, bp, bq, bv, bw = carry[:8]
    door = carry[8:] or (state.door_q, state.door_qd)
    return D.PhysicsState(
        q=q, qd=qd, fq=fq, fqd=fqd, body_pos=bp, body_quat=bq,
        body_linvel=bv, body_angvel=bw, door_q=door[0], door_qd=door[1],
        ee_contact_force=ee)


def control_step(sc: D.MultiBodyConsts, state: D.PhysicsState,
                 controls: D.Controls,
                 n_substeps: int = D.SIM_CALLS_PER_STEP * D.SUBSTEPS_PER_SIM
                 ) -> D.PhysicsState:
    """``n_substeps`` substeps on a batch
    (`PallasMultiBodyEngine.control_step`); without a door, its state passes
    through."""
    carry = carry_of(sc, state)
    ee = torch.zeros_like(state.ee_contact_force)
    for _ in range(n_substeps):
        carry, ee = substep(sc, carry, controls.q_target, controls.f_target,
                            controls.door_motor_on, controls.door_target)
    return state_of(state, carry, ee)
