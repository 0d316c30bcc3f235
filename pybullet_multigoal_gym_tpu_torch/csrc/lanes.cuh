// Contact-lane geometry shared by the control-step kernels K2 (engine.cu)
// and K3 (multibody.cu): box-plane, SAT box-box with incident corners and
// the cross-piercing fallback (two-sided, or one-sided against an immovable
// box), the edge-edge candidate, sphere-plane and sphere-box, and for K2's
// upright cylinder (slide's puck) cylinder-plane and box-cylinder.
// Counterpart of the tile helpers of
// pybullet_multigoal_gym_tpu/ops/pallas_engine.py:225-490; the plain PyTorch
// versions are in ops/engine_plain.py.
//
// A builder computes its lanes for one environment and hands each to
// `emit(point, normal, penetration, active)`, in the Pallas kernels' order;
// the caller attaches the lane's solver metadata and stores it. The normal
// points from side B toward side A (it pushes A out of B).
#pragma once

#include "kin.cuh"

namespace kin {

// The 4 corners of the box face most facing direction d
// (pallas_engine.py:incident_corner_tiles).
KDEV void incident_corners(V3 c, const M3& R, const float h[3], V3 d,
                           V3 out[4]) {
    float dots[3] = {dot(d, col(R, 0)), dot(d, col(R, 1)), dot(d, col(R, 2))};
    float a0 = fabsf(dots[0]), a1 = fabsf(dots[1]), a2 = fabsf(dots[2]);
    int k = (a0 >= a1 && a0 >= a2) ? 0 : (a1 >= a2 ? 1 : 2);
    int k1 = (k + 1) % 3, k2 = (k + 2) % 3;
    V3 f = (sgnf(dots[k]) * h[k]) * col(R, k);
    V3 u = h[k1] * col(R, k1);
    V3 v = h[k2] * col(R, k2);
    V3 base = c + f;
    out[0] = base - u - v;
    out[1] = base - u + v;
    out[2] = base + u - v;
    out[3] = base + u + v;
}

// The half-width of a box along direction L.
KDEV float proj(const M3& R, const float h[3], V3 L) {
    return fabsf(dot(col(R, 0), L)) * h[0] + fabsf(dot(col(R, 1), L)) * h[1] +
           fabsf(dot(col(R, 2), L)) * h[2];
}

KDEV float point_in_box(V3 p, V3 c, const M3& R, const float h[3]) {
    V3 rel = p - c;
    bool in = true;
#pragma unroll
    for (int i = 0; i < 3; ++i) in = in && (h[i] - fabsf(dot(col(R, i), rel)) > -1e-4f);
    return in ? 1.0f : 0.0f;
}

KDEV V3 clamp_into_box(V3 p, V3 c, const M3& R, const float h[3]) {
    V3 rel = p - c;
    V3 loc = {clampf(dot(col(R, 0), rel), -h[0], h[0]),
              clampf(dot(col(R, 1), rel), -h[1], h[1]),
              clampf(dot(col(R, 2), rel), -h[2], h[2])};
    return c + mat3vec(R, loc);
}

// 4-lane box vs plane: the bottom-face incident corners.
template <class Emit>
KDEV void box_plane_lanes(V3 c, const M3& R, const float h[3], float plane_z,
                          Emit&& emit) {
    V3 cs[4];
    incident_corners(c, R, h, V3{0.0f, 0.0f, -1.0f}, cs);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        float pen = plane_z - cs[k].z;
        emit(cs[k], V3{0.0f, 0.0f, 1.0f}, pen, pen > -1e-4f ? 1.0f : 0.0f);
    }
}

// SAT box (A) vs box (B) manifold: 4 incident-face corners of A in B, 4 of
// B in A (TWO_SIDED only), 1 cross-piercing fallback: 9 lanes two-sided
// (pallas_engine.py:sat_box_box_lanes), 5 one-sided, where B cannot move
// (pallas_multibody.py:_one_sided: a pinned body, a static wall).
template <bool TWO_SIDED, class Emit>
KDEV void box_box_manifold(V3 ca, const M3& Ra, const float ha[3], V3 cb,
                           const M3& Rb, const float hb[3], Emit&& emit) {
    V3 t = ca - cb;
    float best = 0.0f, sat_ok = 1.0f;
    V3 n = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int a = 0; a < 6; ++a) {
        V3 Lx = a < 3 ? col(Ra, a) : col(Rb, a - 3);
        float tl = dot(t, Lx);
        float ov = proj(Ra, ha, Lx) + proj(Rb, hb, Lx) - fabsf(tl);
        sat_ok = sat_ok * (ov > -1e-4f ? 1.0f : 0.0f);
        if (a == 0 || ov < best) {
            best = ov;
            n = Lx * sgnf(tl);
        }
    }
    float ra_n = proj(Ra, ha, n), rb_n = proj(Rb, hb, n);
    float inside_any = 0.0f;
    V3 cs[4];
    incident_corners(ca, Ra, ha, -n, cs);         // A corners toward B
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        float pen = rb_n - dot(n, cs[k] - cb);
        float in = point_in_box(cs[k], cb, Rb, hb);
        inside_any = fmaxf(inside_any, in);
        emit(cs[k], n, pen, in * sat_ok);
    }
    if (TWO_SIDED) {
        incident_corners(cb, Rb, hb, n, cs);      // B corners toward A
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            float pen = dot(n, cs[k] - ca) + ra_n;
            float in = point_in_box(cs[k], ca, Ra, ha);
            inside_any = fmaxf(inside_any, in);
            emit(cs[k], n, pen, in * sat_ok);
        }
    }
    V3 p_cross = 0.5f * (clamp_into_box(ca, cb, Rb, hb) +
                         clamp_into_box(cb, ca, Ra, ha));
    emit(p_cross, n, best, sat_ok * (1.0f - inside_any));
}

// 9-lane SAT box (A) vs box (B) manifold.
template <class Emit>
KDEV void sat_box_box_lanes(V3 ca, const M3& Ra, const float ha[3], V3 cb,
                            const M3& Rb, const float hb[3], Emit&& emit) {
    box_box_manifold<true>(ca, Ra, ha, cb, Rb, hb, emit);
}

// Edge-edge candidate of box A vs box B (pallas_engine.py:edge_lane_tiles,
// contact.py:box_box_edge): 1 lane, active when an edge-cross axis is the
// 15-axis SAT minimum by more than 20 % + 1 mm of the best face axis.
template <class Emit>
KDEV void edge_lane(V3 ca, const M3& Ra, const float ha[3], V3 cb,
                    const M3& Rb, const float hb[3], Emit&& emit) {
    V3 t = ca - cb;
    float min_f = 0.0f, sat_ok = 1.0f;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
        V3 Lx = a < 3 ? col(Ra, a) : col(Rb, a - 3);
        float ov = proj(Ra, ha, Lx) + proj(Rb, hb, Lx) - fabsf(dot(t, Lx));
        sat_ok = sat_ok * (ov > -1e-4f ? 1.0f : 0.0f);
        min_f = a == 0 ? ov : fminf(min_f, ov);
    }
    float min_e = 0.0f;
    V3 n = {0.0f, 0.0f, 0.0f}, pt = {0.0f, 0.0f, 0.0f};
#pragma unroll 1
    for (int ij = 0; ij < 9; ++ij) {
        const int i = ij / 3, j = ij % 3;
        V3 ea = col(Ra, i), eb = col(Rb, j);
        V3 L = cross(ea, eb);
        float Ln = sqrtf(fmaxf(dot(L, L), 1e-18f));
        V3 Lu = {L.x / Ln, L.y / Ln, L.z / Ln};
        float ov = proj(Ra, ha, Lu) + proj(Rb, hb, Lu) - fabsf(dot(t, Lu));
        if (!(Ln > 1e-6f)) ov = 1e9f;         // parallel edges: no axis
        sat_ok = sat_ok * (ov > -1e-4f ? 1.0f : 0.0f);
        V3 n_ij = Lu * sgnf(dot(t, Lu));
        // the support edges: A's edge along ea nearest B, B's along eb
        V3 pa = ca, pb = cb;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            if (k != i)
                pa = pa + (sgnf(dot(-n_ij, col(Ra, k))) * ha[k]) * col(Ra, k);
            if (k != j)
                pb = pb + (sgnf(dot(n_ij, col(Rb, k))) * hb[k]) * col(Rb, k);
        }
        // closest points of the two edge lines, clamped to the edges
        V3 r = pa - pb;
        float b_ = dot(ea, eb), c_ = dot(ea, r), d_ = dot(eb, r);
        float den = fmaxf(1.0f - b_ * b_, 1e-9f);
        float s_ = (b_ * d_ - c_) / den;
        float u_ = d_ + b_ * s_;
        s_ = clampf(s_, -ha[i], ha[i]);
        u_ = clampf(u_, -hb[j], hb[j]);
        V3 p = 0.5f * (pa + s_ * ea + pb + u_ * eb);
        if (ij == 0 || ov < min_e) {
            min_e = ov;
            n = n_ij;
            pt = p;
        }
    }
    float edge_wins = min_e < fminf(min_f * 0.8f, min_f) - 1e-3f ? 1.0f : 0.0f;
    emit(pt, n, min_e, sat_ok * edge_wins * (min_e > -1e-4f ? 1.0f : 0.0f));
}

// One-sided box (A, free) vs box (B, immovable): 5 lanes, and with EDGE
// the edge-edge candidate after them (pallas_multibody.py:_one_sided).
template <bool EDGE, class Emit>
KDEV void box_box_one_sided(V3 ca, const M3& Ra, const float ha[3], V3 cb,
                            const M3& Rb, const float hb[3], Emit&& emit) {
    box_box_manifold<false>(ca, Ra, ha, cb, Rb, hb, emit);
    if (EDGE) edge_lane(ca, Ra, ha, cb, Rb, hb, emit);
}

// The cylinder's rim points at angles 2 pi k / 4 as factors of the radius:
// the float32 roundings of their cosines and sines (ops/engine_plain.py's
// _RIM_COS / _RIM_SIN).
KTABLE float RIM_COS[4] = {1.0, 6.123233995736766e-17, -1.0,
                           -1.8369701987210297e-16};
KTABLE float RIM_SIN[4] = {0.0, 1.0, 1.2246467991473532e-16, -1.0};

// 4-lane upright cylinder vs plane: the bottom cap's rim points, placed
// with the body quaternion (pallas_engine.py:_cyl_plane_lanes).
template <class Emit>
KDEV void cyl_plane_lanes(V3 c, Q4 q, float radius, float half_len,
                          float plane_z, Emit&& emit) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        V3 loc = {radius * RIM_COS[k], radius * RIM_SIN[k], -half_len};
        V3 p = c + qrotate(q, loc);
        float pen = plane_z - p.z;
        emit(p, V3{0.0f, 0.0f, 1.0f}, pen, pen > -1e-4f ? 1.0f : 0.0f);
    }
}

// Box (side B, a finger pad) vs upright cylinder (side A, the puck): a
// lateral lane and a vertical lane, exclusive, keyed on the smaller
// penetration (pallas_engine.py:box_cyl_lanes); the normals point from the
// box toward the cylinder. Where the cylinder's axis lies inside the box in
// the box's xy (d_xy <= 1e-6), the lateral lane leaves through the nearer
// side face.
template <class Emit>
KDEV void box_cyl_lanes(V3 cb, const M3& Rb, const float hb[3], V3 cc,
                        float radius, float half_len, Emit&& emit) {
    V3 rel = cc - cb;
    float cl[3] = {dot(col(Rb, 0), rel), dot(col(Rb, 1), rel),
                   dot(col(Rb, 2), rel)};
    float dx = cl[0] - clampf(cl[0], -hb[0], hb[0]);
    float dy = cl[1] - clampf(cl[1], -hb[1], hb[1]);
    float d_xy = sqrtf(dx * dx + dy * dy);
    float outside = d_xy > 1e-6f ? 1.0f : 0.0f;
    float e0 = hb[0] - fabsf(cl[0]), e1 = hb[1] - fabsf(cl[1]);
    float is0 = e0 <= e1 ? 1.0f : 0.0f;
    float emin = fminf(e0, e1);
    float lat_pen = (radius - d_xy) * outside + (radius + emin) * (1.0f - outside);
    float inv = 1.0f / fmaxf(d_xy, 1e-6f);
    float nx = dx * inv * outside + is0 * sgnf(cl[0]) * (1.0f - outside);
    float ny = dy * inv * outside + (1.0f - is0) * sgnf(cl[1]) * (1.0f - outside);
    V3 n_lat = mat3vec(Rb, V3{nx, ny, 0.0f});
    float z_reach = hb[2] + half_len;
    float vert_pen = z_reach - fabsf(cl[2]);
    float in_xy = (fabsf(cl[0]) < hb[0] + radius && fabsf(cl[1]) < hb[1] + radius)
                      ? 1.0f : 0.0f;
    float side_is_min = lat_pen <= vert_pen ? 1.0f : 0.0f;
    float lat_act = (lat_pen > -1e-4f && fabsf(cl[2]) < z_reach ? 1.0f : 0.0f) *
                    side_is_min;
    float vert_act = (vert_pen > -1e-4f ? 1.0f : 0.0f) * in_xy * (1.0f - side_is_min);
    V3 n_vert = mat3vec(Rb, V3{0.0f, 0.0f, sgnf(cl[2])});
    emit(cc - n_lat * radius, n_lat, lat_pen, lat_act);
    emit(cc - n_vert * half_len, n_vert, vert_pen, vert_act);
}

// Sphere vs support plane: 1 lane.
template <class Emit>
KDEV void sphere_plane_lane(V3 c, float radius, float plane_z, Emit&& emit) {
    float pen = (plane_z + radius) - c.z;
    emit(V3{c.x, c.y, c.z - radius}, V3{0.0f, 0.0f, 1.0f}, pen,
         pen > -1e-4f ? 1.0f : 0.0f);
}

// Sphere (A) vs box (B): 1 lane; the normal pushes the sphere out.
template <class Emit>
KDEV void sphere_box_lane(V3 c, float radius, V3 cb, const M3& Rb,
                          const float hb[3], Emit&& emit) {
    V3 rel = c - cb;
    float cl[3] = {dot(col(Rb, 0), rel), dot(col(Rb, 1), rel),
                   dot(col(Rb, 2), rel)};
    V3 delta = {cl[0] - clampf(cl[0], -hb[0], hb[0]),
                cl[1] - clampf(cl[1], -hb[1], hb[1]),
                cl[2] - clampf(cl[2], -hb[2], hb[2])};
    float dd = dot(delta, delta);
    float d = sqrtf(fmaxf(dd, 1e-18f));
    bool outside = dd > 1e-18f;
    V3 n_local;
    float pen;
    if (outside) {
        n_local = {delta.x / d, delta.y / d, delta.z / d};
        pen = radius - d;
    } else {
        float e0 = hb[0] - fabsf(cl[0]), e1 = hb[1] - fabsf(cl[1]),
              e2 = hb[2] - fabsf(cl[2]);
        float emin = fminf(e0, fminf(e1, e2));
        int k = (e0 <= e1 && e0 <= e2) ? 0 : (e1 <= e2 ? 1 : 2);
        n_local = {k == 0 ? sgnf(cl[0]) : 0.0f, k == 1 ? sgnf(cl[1]) : 0.0f,
                   k == 2 ? sgnf(cl[2]) : 0.0f};
        pen = radius + emin;
    }
    V3 n = mat3vec(Rb, n_local);
    emit(c - n * radius, n, pen, pen > -1e-4f ? 1.0f : 0.0f);
}

}  // namespace kin
