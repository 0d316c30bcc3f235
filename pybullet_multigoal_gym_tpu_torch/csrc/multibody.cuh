// K3: the whole control step of a scene with several free and pinned
// bodies, static boxes and a prismatic door (n_substeps velocity-level 2 ms
// substeps) fused into one launch, one thread per environment. The kernel
// template; its instances are in multibody.cu (the scenes without a chest),
// chest_push.cu and chest_pick.cu (the chest tasks) and multibody_robotiq.cu
// (the block scenes with the Robotiq-85), each built into its own library.
//
// Replaces pybullet_multigoal_gym_tpu/ops/pallas_multibody.py:_build_kernel
// (launched through PallasMultiBodyEngine.control_step) for scenes of free and
// pinned bodies made of box geoms of any size, static boxes and a prismatic
// door, with the parallel-jaw gripper: block_stack and block_rearrange with
// 1-5 blocks, chest_push and chest_pick_and_place with 1-5 blocks, the
// push-primitive tasks (a slot of three boxes and a cube, or a rectangle) and
// insertion (a free rectangle and a pinned slot of four boxes); and
// block_stack and block_rearrange with the Robotiq-85. The gripper is the
// first template integer (kin.cuh: finger_frames, Grip). Same physics as
// ops/multibody_plain.py, the plain PyTorch version it is checked against, and
// the same lane order (pallas_multibody.py:398-517): per free body, per geom
// of it, the plane (4), both fingers (2 x 9 SAT), then per static box, per
// geom of a pinned body and per door panel a one-sided manifold (5) and the
// edge-edge candidate; per geom of a pinned body both fingers (2 x 9 SAT, the
// geom as side A); per pair of free bodies, per pair of their geoms, a SAT
// manifold (9) and the edge-edge candidate; per finger, per door panel, a SAT
// manifold (9, the panel as side A); per finger its pad on the plane (4) and
// against each static box (one-sided, 5, the pad as side A); the arm-sphere
// lanes that ops/lane_cull.py keeps, per geom, static box and door panel. A
// geom's centre is its body's position plus R times its offset; every lane of
// a free body's geom acts on its body. A pinned body is immovable: no gravity,
// no plane lanes, no integration, and a lane's pinned side adds nothing to its
// effective mass and takes no impulse, as the world's side does; a static box
// is the world at a fixed centre with the identity rotation. The door is one
// prismatic degree of freedom: its panels ride on the frame anchor + axis *
// door_q with the identity rotation, a door side moves at axis * door_qd, adds
// (d . axis)^2 / m_door times its count of active lanes to a lane's effective
// mass and takes the lane's impulse along its axis; before the contacts a
// servo drives it toward its hold-open target (or it coasts), and it
// integrates clamped to [0, limit]. The solver is K2's (engine.cu) with a
// lane's two sides made general: each side is a body, a finger (riding on the
// arm), an arm sphere, the door or the world.
//
// Design. As in K2 the state stays on chip for the whole control step, read
// once and written once as SoA (rows, n) arrays. The scene's structure is a
// template (the gripper, bodies, geoms, each geom's body, which arm spheres
// keep a plane lane and a lane on each geom, the geoms off their body's
// origin, the pinned bodies, the static boxes and the arm spheres that keep a
// lane on each, the door's panels and the spheres that keep a lane on them),
// so the lane plan is static; the sizes, offsets, centres, frictions and the
// door's frame come with the parameters. Statics and door panels are kept out
// of the geom table: each has its own sphere mask word. A scene holds up to
// 558 lanes, most of them inactive in any substep (bodies apart, fingers
// away): the lane builders keep only the active lanes, in plan order, so the
// solver's arrays (about 35 words a lane, in per-thread local memory) are
// touched only as deep as the contacts of this substep reach, and every sum
// runs over the same lanes in the same order as the dense plan (an inactive
// lane adds exact zeros). A scene without statics or a door compiles none of
// their code.
//
// Bound: operations (tests/kernels_count.cpp counts them), against
// (2 x (18 + 13 NB + 5) + 11) floats of traffic per environment and step.
// One thread per environment leaves most of the card idle at 4096
// environments; spreading an environment's lanes over a warp is later work.
#pragma once

#include "lanes.cuh"

// the scene-structure helpers below serve the host's constant expressions
// and the device code alike
#ifdef __CUDACC__
#define KHD __host__ __device__
#else
#define KHD
#endif

namespace kin {
namespace mb {

// Scene parameters, in the order of ops/cuda_multibody.py:scene_params:
// global values, then per body (inverse mass, inverse inertia 3, friction
// vs the plane, the fingers, the arm spheres), then the pair frictions (NB
// x NB, row-major), then the geom table (per geom: half extents 3, offset
// in the body frame 3); with static boxes, the static table (per static:
// half extents 3, world centre 3, friction vs a pad and vs an arm sphere)
// and the frictions of each body against each static (NB x NS); with a
// door, its frame and dynamics (anchor 3, axis 3, limit, inverse mass, the
// servo's authority per substep, the coast factor, friction vs a pad and vs
// an arm sphere), each body's friction against it (NB), and its panels
// (per panel: half extents 3, offset in the door frame 3).
enum { P_PLANE_Z, P_ERP_DT, P_SLOP, P_MU_FPLANE, P_MU_SPLANE, P_BODY };
enum { B_INV_MASS, B_IIX, B_IIY, B_IIZ, B_MU_PLANE, B_MU_FINGER, B_MU_SPHERE,
       B_N };
enum { G_HX, G_HY, G_HZ, G_OX, G_OY, G_OZ, G_N };
enum { S_HX, S_HY, S_HZ, S_CX, S_CY, S_CZ, S_MU_FINGER, S_MU_SPHERE, S_N };
enum { D_AX, D_AY, D_AZ, D_UX, D_UY, D_UZ, D_LIMIT, D_INV_MASS, D_SERVO_DV,
       D_COAST, D_MU_FINGER, D_MU_SPHERE, D_N };

// state rows: q 7, qd 7, fq 2, fqd 2, then per body pos 3, quat 4, linvel 3,
// angvel 3, then the door q and qd (passed through without a door), EE
// force 3; controls: q target 7, finger target 2, door motor on, door target
enum { R_Q = 0, R_QD = 7, R_FQ = 14, R_FQD = 16, R_BODY = 18 };
enum { C_QT = 0, C_FT = 7, C_DOOR_ON = 9, C_DOOR_TGT = 10, N_CTRL = 11 };

KHD constexpr int popc7(int m) {
    return (m & 1) + (m >> 1 & 1) + (m >> 2 & 1) + (m >> 3 & 1) +
           (m >> 4 & 1) + (m >> 5 & 1) + (m >> 6 & 1);
}

// The scene's structure, packed into integers: geom g's body in bits
// 4g..4g+3 of GB, the arm spheres that keep a lane on geom g in bits
// 7g..7g+6 of GM (bit sp: sphere sp), and in bit g of OM whether geom g
// sits off its body's origin; the arm spheres that keep a lane on static s
// in bits 7s..7s+6 of SM, and on the door's panels in DM.
KHD constexpr int geom_body(unsigned gb, int g) { return (gb >> (4 * g)) & 15; }
KHD constexpr int geom_mask(unsigned long long gm, int g) {
    return (int)((gm >> (7 * g)) & 0x7f);
}
KHD constexpr int static_mask(unsigned sm, int s) {
    return (int)((sm >> (7 * s)) & 0x7f);
}

// Whether body b is pinned: bit b of PIN.
KHD constexpr bool pinned(int pin, int b) { return (pin >> b) & 1; }

// Lanes in the plan: per free geom plane 4 + fingers 2 x 9 + 6 per static,
// pinned geom and door panel; per pinned geom fingers 2 x 9; per geom pair
// of two free bodies 10; per finger 9 per door panel; per finger its pad on
// the plane 4 + 5 per static; the kept sphere lanes.
constexpr int lane_count(int ng, unsigned gb, int plane_mask,
                         unsigned long long gm, int pin, int ns, unsigned sm,
                         int nd, int dm) {
    int n_pinned = 0;
    for (int g = 0; g < ng; ++g) n_pinned += pinned(pin, geom_body(gb, g));
    int l = 8 + popc7(plane_mask) + 18 * nd + 10 * ns + nd * popc7(dm);
    for (int s = 0; s < ns; ++s) l += popc7(static_mask(sm, s));
    for (int g = 0; g < ng; ++g) {
        const int b = geom_body(gb, g);
        l += popc7(geom_mask(gm, g));
        l += pinned(pin, b) ? 18 : 22 + 6 * (n_pinned + ns + nd);
        for (int g2 = g + 1; g2 < ng; ++g2)
            if (geom_body(gb, g2) != b && !pinned(pin, b) &&
                !pinned(pin, geom_body(gb, g2)))
                l += 10;
    }
    return l;
}

// Whether the geoms come body by body (each body's geoms together, bodies in
// order), and no body of three or more has several geoms: then looping over
// geoms, and over geom pairs g < g2 of two bodies, visits them in the lane
// plan's order (per body, per pair of bodies).
constexpr bool plan_order_by_geom(int nb, int ng, unsigned gb) {
    bool several = false;
    for (int g = 1; g < ng; ++g) {
        if (geom_body(gb, g) < geom_body(gb, g - 1)) return false;
        several = several || geom_body(gb, g) == geom_body(gb, g - 1);
    }
    return nb < 3 || !several;
}

// The spheres that keep a lane on some geom.
constexpr int any_geom_mask(int ng, unsigned long long gm) {
    int m = 0;
    for (int g = 0; g < ng; ++g) m |= geom_mask(gm, g);
    return m;
}

// The spheres that keep a lane on some static box.
constexpr int any_static_mask(int ns, unsigned sm) {
    int m = 0;
    for (int s = 0; s < ns; ++s) m |= static_mask(sm, s);
    return m;
}

template <int NB, int NG, unsigned GB, int PLANE_MASK, unsigned long long GM,
          int OM, int PIN, int NS, unsigned SM, int ND, int DM>
struct Plan {
    static constexpr int ROWS = R_BODY + 13 * NB + 5;
    static constexpr int R_DOOR = R_BODY + 13 * NB, R_EE = R_DOOR + 2;
    static constexpr int L =
        lane_count(NG, GB, PLANE_MASK, GM, PIN, NS, SM, ND, DM);
    static constexpr int ANY_GEOM_MASK = any_geom_mask(NG, GM);
    static constexpr int ANY_STATIC_MASK = any_static_mask(NS, SM);
    static constexpr int DOOR_MASK = ND > 0 ? DM : 0;
    static_assert(plan_order_by_geom(NB, NG, GB),
                  "the kernel visits geoms in geom order: see "
                  "plan_order_by_geom");
};

// A lane's sides and static solver metadata (pallas_multibody.py:68-107):
// side A's body (ba) or finger (fa) or arm sphere or the door (ba ==
// DOOR_SIDE), side B's body (bb) or finger (fb) or the door (bb ==
// DOOR_SIDE) or the world; the arm joints 0..lk that carry the lane's arm
// side, the arm sign, whether the arm yields in the solve, the EE-sensor
// sign and the friction. (The door rides in the body fields rather than in
// a field of its own, so the record keeps its size and the scenes without a
// door their registers and spills.)
struct Meta {
    signed char ba, bb, fa, fb, lk, arm, cpl;
    float asg, esg, mu;
};
constexpr int DOOR_SIDE = -2;

KDEV Meta meta(int ba, int bb, int fa, int fb, int lk, bool arm, bool cpl,
               float asg, float esg, float mu) {
    Meta m;
    m.ba = (signed char)ba; m.bb = (signed char)bb;
    m.fa = (signed char)fa; m.fb = (signed char)fb;
    m.lk = (signed char)lk; m.arm = arm; m.cpl = cpl;
    m.asg = asg; m.esg = esg; m.mu = mu;
    return m;
}

// The active lanes of one substep, in plan order, with their solver state.
template <int L>
struct Lanes {
    V3 pt[L], nrm[L], t1[L], t2[L], ra[L], rb[L], varm[L];
    float pen[L], kn[L], kt1[L], kt2[L], bias[L], ln[L], lt1[L], lt2[L];
    bool solv[L];
    Meta mt[L];
    int count = 0;

    KDEV void add(V3 p, V3 n, float pe, float act, const Meta& m) {
        if (!(act > 0.0f)) return;
        int l = count++;
        pt[l] = p; nrm[l] = n; pen[l] = pe; mt[l] = m;
    }
};

// One environment, n_sub substeps.
template <int GRIP, int NB, int NG, unsigned GB, int PLANE_MASK,
          unsigned long long GM, int OM, int PIN, int NS, unsigned SM, int ND,
          int DM>
KDEV void multibody_env(const float* __restrict__ st,
                        const float* __restrict__ ctl,
                        const float* __restrict__ prm, float* __restrict__ out,
                        int n, int i, int n_sub, int iters) {
    using P = Plan<NB, NG, GB, PLANE_MASK, GM, OM, PIN, NS, SM, ND, DM>;
    constexpr int L = P::L;
    constexpr bool DOOR = ND > 0;
    constexpr int NS1 = NS > 0 ? NS : 1, ND1 = DOOR ? ND : 1;
    const float plane_z = prm[P_PLANE_Z], erp_dt = prm[P_ERP_DT];
    const float slop = prm[P_SLOP];
    const float mu_fplane = prm[P_MU_FPLANE], mu_splane = prm[P_MU_SPLANE];
    using G = Grip<GRIP>;
    const float fhalf[3] = {G::half(0), G::half(1), G::half(2)};
    float inv_mass[NB], inv_I[NB][3], mu_plane[NB], mu_finger[NB],
        mu_sphere[NB], mu_pair[NB][NB];
    for (int b = 0; b < NB; ++b) {
        const float* pb = prm + P_BODY + B_N * b;
        for (int k = 0; k < 3; ++k) inv_I[b][k] = pb[B_IIX + k];
        inv_mass[b] = pb[B_INV_MASS];
        mu_plane[b] = pb[B_MU_PLANE];
        mu_finger[b] = pb[B_MU_FINGER];
        mu_sphere[b] = pb[B_MU_SPHERE];
        for (int b2 = 0; b2 < NB; ++b2)
            mu_pair[b][b2] = prm[P_BODY + B_N * NB + NB * b + b2];
    }
    // the geom table: the half extents held, the offsets of the geoms off
    // their body's origin read where a centre is needed
    const float* geoms = prm + P_BODY + (B_N + NB) * NB;
    float half[NG][3];
    for (int g = 0; g < NG; ++g)
        for (int k = 0; k < 3; ++k) half[g][k] = geoms[G_N * g + G_HX + k];
    // the static boxes and the door's panels: world boxes with the identity
    // rotation
    const M3 eye = {{{1.0f, 0.0f, 0.0f}, {0.0f, 1.0f, 0.0f},
                     {0.0f, 0.0f, 1.0f}}};
    const float* stat = geoms + G_N * NG;
    float shalf[NS1][3], mu_fstatic[NS1], mu_sstatic[NS1], mu_static[NB][NS1];
    V3 scen[NS1];
    for (int s = 0; s < NS; ++s) {
        const float* ps = stat + S_N * s;
        for (int k = 0; k < 3; ++k) shalf[s][k] = ps[S_HX + k];
        scen[s] = {ps[S_CX], ps[S_CY], ps[S_CZ]};
        mu_fstatic[s] = ps[S_MU_FINGER];
        mu_sstatic[s] = ps[S_MU_SPHERE];
        for (int b = 0; b < NB; ++b)
            mu_static[b][s] = stat[S_N * NS + NS * b + s];
    }
    const float* dp = stat + (S_N + NB) * NS;
    float dhalf[ND1][3], mu_door[NB];
    V3 danchor = {0.0f, 0.0f, 0.0f}, daxis = {0.0f, 0.0f, 0.0f}, doff[ND1];
    float door_limit = 0.0f, door_inv_mass = 0.0f, door_dv = 0.0f,
          door_coast = 0.0f, mu_fdoor = 0.0f, mu_sdoor = 0.0f;
    if (DOOR) {
        danchor = {dp[D_AX], dp[D_AY], dp[D_AZ]};
        daxis = {dp[D_UX], dp[D_UY], dp[D_UZ]};
        door_limit = dp[D_LIMIT];
        door_inv_mass = dp[D_INV_MASS];
        door_dv = dp[D_SERVO_DV];
        door_coast = dp[D_COAST];
        mu_fdoor = dp[D_MU_FINGER];
        mu_sdoor = dp[D_MU_SPHERE];
        for (int b = 0; b < NB; ++b) mu_door[b] = dp[D_N + b];
        for (int d = 0; d < ND; ++d) {
            const float* pd = dp + D_N + NB + G_N * d;
            for (int k = 0; k < 3; ++k) dhalf[d][k] = pd[G_HX + k];
            doff[d] = {pd[G_OX], pd[G_OY], pd[G_OZ]};
        }
    }

    float q[7], qd[7], qt[7], fq[2], fqd[2], ft[2];
#pragma unroll
    for (int j = 0; j < 7; ++j) {
        q[j] = st[(R_Q + j) * n + i];
        qd[j] = st[(R_QD + j) * n + i];
        qt[j] = ctl[(C_QT + j) * n + i];
    }
#pragma unroll
    for (int f = 0; f < 2; ++f) {
        fq[f] = st[(R_FQ + f) * n + i];
        fqd[f] = st[(R_FQD + f) * n + i];
        ft[f] = ctl[(C_FT + f) * n + i];
    }
    V3 bp[NB], bv[NB], bw[NB];
    Q4 bq[NB];
    for (int b = 0; b < NB; ++b) {
        const float* s = st + (R_BODY + 13 * b) * n + i;
        bp[b] = {s[0], s[n], s[2 * n]};
        bq[b] = {s[3 * n], s[4 * n], s[5 * n], s[6 * n]};
        bv[b] = {s[7 * n], s[8 * n], s[9 * n]};
        bw[b] = {s[10 * n], s[11 * n], s[12 * n]};
    }
    V3 ee = {0.0f, 0.0f, 0.0f};
    // the door's state and controls (a scene without a door reads none and
    // passes its state through)
    float door_q = 0.0f, door_qd = 0.0f, door_on = 0.0f, door_tgt = 0.0f;
    if (DOOR) {
        door_q = st[P::R_DOOR * n + i];
        door_qd = st[(P::R_DOOR + 1) * n + i];
        door_on = ctl[C_DOOR_ON * n + i];
        door_tgt = ctl[C_DOOR_TGT * n + i];
    }

    Lanes<L> ls;
    M3 R[NB], Iw[NB];
    // geom g's centre (of body b) at the current coordinates: a geom at its
    // body's origin takes the body's position, as pallas_multibody.py:393-397
    // does
    auto centre = [&](int g, int b) {
        if (!((OM >> g) & 1)) return bp[b];
        const float* pg = geoms + G_N * g;
        return bp[b] + mat3vec(R[b], V3{pg[G_OX], pg[G_OY], pg[G_OZ]});
    };
    V3 bv_[NB], bw_[NB], dv[NB], dw[NB];

#pragma unroll 1
    for (int s = 0; s < n_sub; ++s) {
        // 1. arm servo -> proposed qd (q integrates after the solve)
#pragma unroll
        for (int j = 0; j < 7; ++j) {
            float v_des = clampf(ARM_SERVO_RATE * (qt[j] - q[j]), -ARM_VEL_LIMIT,
                                 ARM_VEL_LIMIT);
            float dvj = ARM_PD_FORCE * DT / ARM_INERTIA[j];
            qd[j] = qd[j] + clampf(v_des - qd[j], -dvj, dvj);
        }
        // 2. FK at the current configuration
        V3 o[7], z[7];
        Q4 r[7];
        link_frames(q, o, r);
#pragma unroll
        for (int j = 0; j < 7; ++j) z[j] = qrotate(r[j], V3{0.0f, 0.0f, 1.0f});
        Q4 r7 = r[6];
        M3 Rb7 = qmat(r7);
        V3 fpos[2], faxis[2];
        finger_frames<GRIP>(o[6], r7, fq, fpos, faxis);
        // 3. finger servo
#pragma unroll
        for (int f = 0; f < 2; ++f) {
            float v_des = clampf(ARM_SERVO_RATE * (ft[f] - fq[f]),
                                 -G::vel_limit(), G::vel_limit());
            float dvf = G::force() * DT / G::mass();
            fqd[f] = fqd[f] + clampf(v_des - fqd[f], -dvf, dvf);
        }
        // 4. gravity on the free bodies
#pragma unroll 1
        for (int b = 0; b < NB; ++b) {
            if (!pinned(PIN, b)) bv[b].z = bv[b].z - GRAVITY * DT;
            R[b] = qmat(bq[b]);
        }

        // 5. the door: servo toward the hold-open target where its motor
        // is on, else a free coast; its panels at the current door_q
        V3 dc[ND1];
        if (DOOR) {
            float dv_des = clampf(ARM_SERVO_RATE * (door_tgt - door_q), -1.0f,
                                  1.0f);
            door_qd = door_on > 0.0f
                          ? door_qd + clampf(dv_des - door_qd, -door_dv, door_dv)
                          : door_qd * door_coast;
            const V3 dpos = danchor + daxis * door_q;
            for (int d = 0; d < ND; ++d) dc[d] = dpos + doff[d];
        }

        // 6. contact lanes, in the order of pallas_multibody.py:398-517;
        // only the active ones are kept
        ls.count = 0;
#pragma unroll 1
        for (int g = 0; g < NG; ++g) {
            const int b = geom_body(GB, g);
            if (pinned(PIN, b)) continue;
            const V3 c = centre(g, b);
            const Meta mp = meta(b, -1, -1, -1, -1, false, false, 0.0f, 0.0f,
                                 mu_plane[b]);
            box_plane_lanes(c, R[b], half[g], plane_z,
                            [&](V3 p, V3 nl, float pen, float act) {
                                ls.add(p, nl, pen, act, mp);
                            });
#pragma unroll 1
            for (int f = 0; f < 2; ++f) {
                const Meta mf = meta(b, -1, -1, f, 6, false, false, -1.0f,
                                     -1.0f, mu_finger[b]);
                sat_box_box_lanes(c, R[b], half[g], fpos[f], Rb7, fhalf,
                                  [&](V3 p, V3 nl, float pen, float act) {
                                      ls.add(p, nl, pen, act, mf);
                                  });
            }
            // the static boxes (side B the world)
#pragma unroll 1
            for (int s = 0; s < NS; ++s) {
                const Meta mw = meta(b, -1, -1, -1, -1, false, false, 0.0f,
                                     0.0f, mu_static[b][s]);
                box_box_one_sided<true>(
                    c, R[b], half[g], scen[s], eye, shalf[s],
                    [&](V3 p, V3 nl, float pen, float act) {
                        ls.add(p, nl, pen, act, mw);
                    });
            }
            // the geoms of pinned bodies, immovable (side B the world)
#pragma unroll 1
            for (int g2 = 0; g2 < NG; ++g2) {
                const int b2 = geom_body(GB, g2);
                if (!pinned(PIN, b2)) continue;
                const Meta mw = meta(b, -1, -1, -1, -1, false, false, 0.0f,
                                     0.0f, mu_pair[b][b2]);
                box_box_one_sided<true>(
                    c, R[b], half[g], centre(g2, b2), R[b2], half[g2],
                    [&](V3 p, V3 nl, float pen, float act) {
                        ls.add(p, nl, pen, act, mw);
                    });
            }
            // the door's panels (side B the door)
#pragma unroll 1
            for (int d = 0; d < ND; ++d) {
                const Meta md = meta(b, DOOR_SIDE, -1, -1, -1, false, false,
                                     0.0f, 0.0f, mu_door[b]);
                box_box_one_sided<true>(
                    c, R[b], half[g], dc[d], eye, dhalf[d],
                    [&](V3 p, V3 nl, float pen, float act) {
                        ls.add(p, nl, pen, act, md);
                    });
            }
        }
        // the fingers against each geom of a pinned body, the geom as side
        // A taking no impulse
#pragma unroll 1
        for (int g = 0; g < NG; ++g) {
            const int b = geom_body(GB, g);
            if (!pinned(PIN, b)) continue;
            const V3 c = centre(g, b);
#pragma unroll 1
            for (int f = 0; f < 2; ++f) {
                const Meta mf = meta(-1, -1, -1, f, 6, false, false, -1.0f,
                                     -1.0f, mu_finger[b]);
                sat_box_box_lanes(c, R[b], half[g], fpos[f], Rb7, fhalf,
                                  [&](V3 p, V3 nl, float pen, float act) {
                                      ls.add(p, nl, pen, act, mf);
                                  });
            }
        }
#pragma unroll 1
        for (int g = 0; g < NG; ++g) {
            const int b = geom_body(GB, g);
            if (pinned(PIN, b)) continue;
            const V3 ca = centre(g, b);
#pragma unroll 1
            for (int g2 = g + 1; g2 < NG; ++g2) {
                const int b2 = geom_body(GB, g2);
                if (b2 == b || pinned(PIN, b2)) continue;
                const Meta mb = meta(b, b2, -1, -1, -1, false, false, 0.0f,
                                     0.0f, mu_pair[b][b2]);
                auto emit = [&](V3 p, V3 nl, float pen, float act) {
                    ls.add(p, nl, pen, act, mb);
                };
                const V3 cb = centre(g2, b2);
                sat_box_box_lanes(ca, R[b], half[g], cb, R[b2], half[g2],
                                  emit);
                edge_lane(ca, R[b], half[g], cb, R[b2], half[g2], emit);
            }
        }
        // the fingers against the door's panels, the panel as side A
#pragma unroll 1
        for (int f = 0; f < 2; ++f) {
#pragma unroll 1
            for (int d = 0; d < ND; ++d) {
                const Meta md = meta(DOOR_SIDE, -1, -1, f, 6, false, false,
                                     -1.0f, -1.0f, mu_fdoor);
                sat_box_box_lanes(dc[d], eye, dhalf[d], fpos[f], Rb7, fhalf,
                                  [&](V3 p, V3 nl, float pen, float act) {
                                      ls.add(p, nl, pen, act, md);
                                  });
            }
        }
        // each pad on the plane, then against each static box (the pad as
        // side A, the arm yielding)
#pragma unroll 1
        for (int f = 0; f < 2; ++f) {
            const Meta mf = meta(-1, -1, f, -1, 6, false, true, 1.0f, 1.0f,
                                 mu_fplane);
            box_plane_lanes(fpos[f], Rb7, fhalf, plane_z,
                            [&](V3 p, V3 nl, float pen, float act) {
                                ls.add(p, nl, pen, act, mf);
                            });
#pragma unroll 1
            for (int s = 0; s < NS; ++s) {
                const Meta mw = meta(-1, -1, f, -1, 6, false, true, 1.0f, 1.0f,
                                     mu_fstatic[s]);
                box_box_one_sided<false>(
                    fpos[f], Rb7, fhalf, scen[s], eye, shalf[s],
                    [&](V3 p, V3 nl, float pen, float act) {
                        ls.add(p, nl, pen, act, mw);
                    });
            }
        }
#pragma unroll
        for (int sp = 0; sp < 7; ++sp) {
            const bool keep_plane = (PLANE_MASK >> sp) & 1;
            const bool keep_body = (P::ANY_GEOM_MASK >> sp) & 1;
            const bool keep_static = (P::ANY_STATIC_MASK >> sp) & 1;
            const bool keep_door = (P::DOOR_MASK >> sp) & 1;
            if (!keep_plane && !keep_body && !keep_static && !keep_door)
                continue;
            const int li = SPH_LINK[sp];
            const float rad = SPH_R[sp];
            const float es = li == 6 ? 1.0f : 0.0f;
            V3 c = o[li] + qrotate(r[li], load3(SPH_OFF[sp]));
            if (keep_plane) {
                const Meta ms = meta(-1, -1, -1, -1, li, true, true, 1.0f, es,
                                     mu_splane);
                sphere_plane_lane(c, rad, plane_z,
                                  [&](V3 p, V3 nl, float pen, float act) {
                                      ls.add(p, nl, pen, act, ms);
                                  });
            }
            if (keep_body) {
#pragma unroll 1
                for (int g = 0; g < NG; ++g) {
                    if (!((geom_mask(GM, g) >> sp) & 1)) continue;
                    const int b = geom_body(GB, g);
                    // side B a free body, or the world for a pinned one
                    const Meta ms = meta(-1, pinned(PIN, b) ? -1 : b, -1, -1,
                                         li, true, true, 1.0f, es,
                                         mu_sphere[b]);
                    sphere_box_lane(c, rad, centre(g, b), R[b], half[g],
                                    [&](V3 p, V3 nl, float pen, float act) {
                                        ls.add(p, nl, pen, act, ms);
                                    });
                }
            }
            if (keep_static) {
#pragma unroll 1
                for (int s = 0; s < NS; ++s) {
                    if (!((static_mask(SM, s) >> sp) & 1)) continue;
                    const Meta ms = meta(-1, -1, -1, -1, li, true, true, 1.0f,
                                         es, mu_sstatic[s]);
                    sphere_box_lane(c, rad, scen[s], eye, shalf[s],
                                    [&](V3 p, V3 nl, float pen, float act) {
                                        ls.add(p, nl, pen, act, ms);
                                    });
                }
            }
            if (keep_door) {
#pragma unroll 1
                for (int d = 0; d < ND; ++d) {
                    const Meta ms = meta(-1, DOOR_SIDE, -1, -1, li, true, true,
                                         1.0f, es, mu_sdoor);
                    sphere_box_lane(c, rad, dc[d], eye, dhalf[d],
                                    [&](V3 p, V3 nl, float pen, float act) {
                                        ls.add(p, nl, pen, act, ms);
                                    });
                }
            }
        }
        const int nl_act = ls.count;

        // 7. solve (fused Jacobi, mass splitting)
#pragma unroll 1
        for (int b = 0; b < NB; ++b) {
#pragma unroll
            for (int a = 0; a < 3; ++a)
#pragma unroll
                for (int k = 0; k < 3; ++k)
                    Iw[b].m[a][k] = R[b].m[a][0] * inv_I[b][0] * R[b].m[k][0] +
                                    R[b].m[a][1] * inv_I[b][1] * R[b].m[k][1] +
                                    R[b].m[a][2] * inv_I[b][2] * R[b].m[k][2];
        }
        // mass-splitting counts: active lanes per body, per finger, of the
        // door, and of the yielding (arm-coupled) lanes
        float count[NB], fcount[2] = {0.0f, 0.0f}, arm_count = 0.0f,
                         dcount = 0.0f;
        for (int b = 0; b < NB; ++b) count[b] = 0.0f;
#pragma unroll 1
        for (int l = 0; l < nl_act; ++l) {
            const Meta& m = ls.mt[l];
            if (m.ba >= 0) count[m.ba] += 1.0f;
            if (m.bb >= 0) count[m.bb] += 1.0f;
            if (m.fa >= 0) fcount[m.fa] += 1.0f;
            if (m.fb >= 0) fcount[m.fb] += 1.0f;
            if (m.cpl) arm_count += 1.0f;
            if (DOOR && (m.ba == DOOR_SIDE || m.bb == DOOR_SIDE))
                dcount += 1.0f;
        }
        for (int b = 0; b < NB; ++b) count[b] = fmaxf(count[b], 1.0f);
        fcount[0] = fmaxf(fcount[0], 1.0f);
        fcount[1] = fmaxf(fcount[1], 1.0f);
        arm_count = fmaxf(arm_count, 1.0f);
        if (DOOR) dcount = fmaxf(dcount, 1.0f);

#pragma unroll 1
        for (int l = 0; l < nl_act; ++l) {
            const Meta m = ls.mt[l];
            V3 nl = ls.nrm[l], p = ls.pt[l];
            ls.ln[l] = ls.lt1[l] = ls.lt2[l] = 0.0f;
            V3 up = fabsf(nl.z) < 0.9f ? V3{0.0f, 0.0f, 1.0f} : V3{1.0f, 0.0f, 0.0f};
            V3 a1 = cross(nl, up);
            a1 = a1 * rsq(fmaxf(dot(a1, a1), 1e-18f));
            ls.t1[l] = a1;
            ls.t2[l] = cross(nl, a1);
            if (m.ba >= 0) ls.ra[l] = p - bp[m.ba];
            if (m.bb >= 0) ls.rb[l] = p - bp[m.bb];
            // frozen arm point velocity sum_j<=lk qd_j (z_j x (p - o_j))
            V3 va = {0.0f, 0.0f, 0.0f};
            for (int j = 0; j <= m.lk; ++j)
                va = va + cross(z[j], p - o[j]) * qd[j];
            ls.varm[l] = va;
            // split-mass effective inverse masses along n, t1, t2: side A,
            // side B, then the yielding arm
            float k3[3];
#pragma unroll
            for (int dir = 0; dir < 3; ++dir) {
                V3 d = dir == 0 ? nl : (dir == 1 ? ls.t1[l] : ls.t2[l]);
                float k = 0.0f;
                if (m.ba >= 0) {
                    V3 rxd = cross(ls.ra[l], d);
                    k = k + (inv_mass[m.ba] + dot(rxd, mat3vec(Iw[m.ba], rxd))) *
                                count[m.ba];
                } else if (m.fa >= 0) {
                    float da = dot(d, faxis[m.fa]);
                    k = k + (da * da / G::mass()) * fcount[m.fa];
                } else if (DOOR && m.ba == DOOR_SIDE) {
                    float dj = dot(d, daxis);
                    k = k + (dj * dj * door_inv_mass) * dcount;
                }
                if (m.fb >= 0) {
                    float da = dot(d, faxis[m.fb]);
                    k = k + (da * da / G::mass()) * fcount[m.fb];
                } else if (m.bb >= 0) {
                    V3 rxd = cross(ls.rb[l], d);
                    k = k + (inv_mass[m.bb] + dot(rxd, mat3vec(Iw[m.bb], rxd))) *
                                count[m.bb];
                } else if (DOOR && m.bb == DOOR_SIDE) {
                    float dj = dot(d, daxis);
                    k = k + (dj * dj * door_inv_mass) * dcount;
                }
                if (m.cpl) {
                    // arm yields: J_j . d = z_j . ((p - o_j) x d)
                    float ka = 0.0f;
                    for (int j = 0; j <= m.lk; ++j) {
                        float jd = dot(cross(p - o[j], d), z[j]);
                        ka = ka + jd * jd * (1.0f / ARM_INERTIA[j]);
                    }
                    k = k + ka * arm_count;
                }
                k3[dir] = k;
            }
            // a direction that moves no DOF is excluded, not floored
            ls.solv[l] = k3[0] > 1e-8f;
            ls.kn[l] = fmaxf(k3[0], 1e-8f);
            ls.kt1[l] = fmaxf(k3[1], 1e-8f);
            ls.kt2[l] = fmaxf(k3[2], 1e-8f);
            // capped recovery velocity
            ls.bias[l] = -fminf(erp_dt * fmaxf(ls.pen[l] - slop, 0.0f), BIAS_CAP);
        }

        for (int b = 0; b < NB; ++b) {
            bv_[b] = bv[b];
            bw_[b] = bw[b];
        }
        float fqd_[2] = {fqd[0], fqd[1]}, door_qd_ = door_qd;
#pragma unroll 1
        for (int it = 0; it < iters; ++it) {
            for (int b = 0; b < NB; ++b)
                dv[b] = dw[b] = V3{0.0f, 0.0f, 0.0f};
            float dfq[2] = {0.0f, 0.0f}, ddoor = 0.0f;
#pragma unroll 1
            for (int l = 0; l < nl_act; ++l) {
                if (!ls.solv[l]) continue;
                const Meta m = ls.mt[l];
                // relative velocity va - vb of the lane's two sides
                V3 va = {0.0f, 0.0f, 0.0f}, vb = {0.0f, 0.0f, 0.0f};
                if (m.ba >= 0)
                    va = bv_[m.ba] + cross(bw_[m.ba], ls.ra[l]);
                else if (m.fa >= 0)
                    va = ls.varm[l] + faxis[m.fa] * fqd_[m.fa];
                else if (m.arm)
                    va = ls.varm[l];
                else if (DOOR && m.ba == DOOR_SIDE)
                    va = daxis * door_qd_;
                if (m.fb >= 0)
                    vb = ls.varm[l] + faxis[m.fb] * fqd_[m.fb];
                else if (m.bb >= 0)
                    vb = bv_[m.bb] + cross(bw_[m.bb], ls.rb[l]);
                else if (DOOR && m.bb == DOOR_SIDE)
                    vb = daxis * door_qd_;
                const bool side_b = m.fb >= 0 || m.bb >= 0 ||
                                    (DOOR && m.bb == DOOR_SIDE);
                V3 v = side_b ? va - vb : va;
                float dln = -(dot(v, ls.nrm[l]) + ls.bias[l]) / ls.kn[l];
                float nln = fmaxf(ls.ln[l] + dln, 0.0f);
                dln = nln - ls.ln[l];
                float lim = m.mu * nln;
                float d1 = -dot(v, ls.t1[l]) / ls.kt1[l];
                float n1 = clampf(ls.lt1[l] + d1, -lim, lim);
                d1 = n1 - ls.lt1[l];
                float d2 = -dot(v, ls.t2[l]) / ls.kt2[l];
                float n2 = clampf(ls.lt2[l] + d2, -lim, lim);
                d2 = n2 - ls.lt2[l];
                ls.ln[l] = nln; ls.lt1[l] = n1; ls.lt2[l] = n2;
                V3 imp = ls.nrm[l] * dln + ls.t1[l] * d1 + ls.t2[l] * d2;
                // side A takes the impulse, side B its opposite
                if (m.ba >= 0) {
                    dv[m.ba] = dv[m.ba] + imp;
                    dw[m.ba] = dw[m.ba] + cross(ls.ra[l], imp);
                } else if (m.fa >= 0) {
                    dfq[m.fa] = dfq[m.fa] + dot(imp, faxis[m.fa]);
                } else if (DOOR && m.ba == DOOR_SIDE) {
                    ddoor = ddoor + dot(imp, daxis);
                }
                if (m.fb >= 0) {
                    dfq[m.fb] = dfq[m.fb] - dot(imp, faxis[m.fb]);
                } else if (m.bb >= 0) {
                    dv[m.bb] = dv[m.bb] - imp;
                    dw[m.bb] = dw[m.bb] - cross(ls.rb[l], imp);
                } else if (DOOR && m.bb == DOOR_SIDE) {
                    ddoor = ddoor - dot(imp, daxis);
                }
            }
#pragma unroll 1
            for (int b = 0; b < NB; ++b) {
                bv_[b] = bv_[b] + dv[b] * inv_mass[b];
                bw_[b] = bw_[b] + mat3vec(Iw[b], dw[b]);
            }
            fqd_[0] = fqd_[0] + dfq[0] / G::mass();
            fqd_[1] = fqd_[1] + dfq[1] / G::mass();
            if (DOOR) door_qd_ = door_qd_ + ddoor * door_inv_mass;
        }

        // arm coupling: accumulated impulses -> joint velocities, once,
        // capped at the motor's per-substep authority; EE force sensor
        float jd[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        V3 fin_imp = {0.0f, 0.0f, 0.0f};
#pragma unroll 1
        for (int l = 0; l < nl_act; ++l) {
            if (!ls.solv[l]) continue;
            const Meta m = ls.mt[l];
            V3 tot = ls.nrm[l] * ls.ln[l] + ls.t1[l] * ls.lt1[l] +
                     ls.t2[l] * ls.lt2[l];
            if (m.esg != 0.0f) fin_imp = fin_imp + tot * m.esg;
            if (m.asg == 0.0f) continue;
            V3 imp_arm = tot * m.asg;
            for (int j = 0; j <= m.lk; ++j)
                jd[j] = jd[j] + dot(cross(ls.pt[l] - o[j], imp_arm), z[j]);
        }
#pragma unroll
        for (int j = 0; j < 7; ++j) {
            float inv = 1.0f / ARM_INERTIA[j];
            float cap = ARM_PD_FORCE * DT * inv;
            qd[j] = qd[j] + clampf(jd[j] * inv, -cap, cap);
        }
        ee = {fin_imp.x / DT, fin_imp.y / DT, fin_imp.z / DT};

        // 8. integrate; joints at a hard stop lose the velocity into it
#pragma unroll
        for (int j = 0; j < 7; ++j) {
            q[j] = clampf(q[j] + qd[j] * DT, JL_LO[j], JL_HI[j]);
            if ((q[j] >= JL_HI[j] && qd[j] > 0.0f) ||
                (q[j] <= JL_LO[j] && qd[j] < 0.0f))
                qd[j] = 0.0f;
        }
#pragma unroll 1
        for (int b = 0; b < NB; ++b) {
            if (pinned(PIN, b)) continue;   // pose and velocities pass through
            bp[b] = bp[b] + bv_[b] * DT;
            V3 w = bw_[b];
            float w_norm = sqrtf(fmaxf(dot(w, w), 1e-18f));
            float half_ang = w_norm * DT * 0.5f;
            float sc = w_norm > 1e-9f ? sinf(half_ang) / w_norm : 0.0f;
            Q4 dq = {cosf(half_ang), w.x * sc, w.y * sc, w.z * sc};
            bq[b] = qnormalize(qmul(dq, bq[b]));
            bv[b] = bv_[b];
            bw[b] = w;
        }
#pragma unroll
        for (int f = 0; f < 2; ++f) {
            fq[f] = clampf(fq[f] + fqd_[f] * DT, G::lo(), G::hi());
            fqd[f] = ((fq[f] >= G::hi() && fqd_[f] > 0.0f) ||
                      (fq[f] <= G::lo() && fqd_[f] < 0.0f))
                         ? 0.0f : fqd_[f];
        }
        if (DOOR) {
            // clamped to [0, limit]; the velocity into a stop is lost
            door_q = clampf(door_q + door_qd_ * DT, 0.0f, door_limit);
            door_qd = (door_q >= door_limit && door_qd_ > 0.0f) ||
                              (door_q <= 0.0f && door_qd_ < 0.0f)
                          ? 0.0f : door_qd_;
        }
    }

#pragma unroll
    for (int j = 0; j < 7; ++j) {
        out[(R_Q + j) * n + i] = q[j];
        out[(R_QD + j) * n + i] = qd[j];
    }
#pragma unroll
    for (int f = 0; f < 2; ++f) {
        out[(R_FQ + f) * n + i] = fq[f];
        out[(R_FQD + f) * n + i] = fqd[f];
    }
    for (int b = 0; b < NB; ++b) {
        float* s = out + (R_BODY + 13 * b) * n + i;
        const float body[13] = {bp[b].x, bp[b].y, bp[b].z, bq[b].w, bq[b].x,
                                bq[b].y, bq[b].z, bv[b].x, bv[b].y, bv[b].z,
                                bw[b].x, bw[b].y, bw[b].z};
        for (int k = 0; k < 13; ++k) s[k * n] = body[k];
    }
    if (DOOR) {
        out[P::R_DOOR * n + i] = door_q;
        out[(P::R_DOOR + 1) * n + i] = door_qd;
    } else {
        out[P::R_DOOR * n + i] = st[P::R_DOOR * n + i];
        out[(P::R_DOOR + 1) * n + i] = st[(P::R_DOOR + 1) * n + i];
    }
    out[P::R_EE * n + i] = ee.x;
    out[(P::R_EE + 1) * n + i] = ee.y;
    out[(P::R_EE + 2) * n + i] = ee.z;
}

}  // namespace mb
}  // namespace kin

// A scene's template arguments as the launch function receives them:
// (gripper, bodies, geoms, geom bodies, plane mask, geom masks, offset
// geoms, pinned bodies, statics, static masks, door panels, door mask),
// packed as Plan says (ops/cuda_multibody.py:scene_key).
#define MB_SCENE_MATCHES(G, NB, NG, GB, PM, GM, OM, PIN, NS, SM, ND, DM)   \
    (grip == G && nb == NB && ng == NG && geom_bodies == GB &&            \
     plane_mask == PM && geom_masks == GM##ULL && offset_geoms == OM &&   \
     pinned_bodies == PIN && statics == NS && static_masks == SM##u &&    \
     door_panels == ND && door_mask == DM)
#define MB_SCENE_ARGS(G, NB, NG, GB, PM, GM, OM, PIN, NS, SM, ND, DM)      \
    G, NB, NG, GB, PM, GM##ULL, OM, PIN, NS, SM##u, ND, DM
#define MB_LAUNCH_PARAMS                                                    \
    int grip, int nb, int ng, unsigned geom_bodies, int plane_mask,         \
        unsigned long long geom_masks, int offset_geoms, int pinned_bodies, \
        int statics, unsigned static_masks, int door_panels, int door_mask

#ifdef __CUDACC__
template <int GRIP, int NB, int NG, unsigned GB, int PLANE_MASK,
          unsigned long long GM, int OM, int PIN, int NS, unsigned SM, int ND,
          int DM>
__global__ void __launch_bounds__(32)
multibody_kernel(const float* __restrict__ st, const float* __restrict__ ctl,
                 const float* __restrict__ prm, float* __restrict__ out, int n,
                 int n_sub, int iters) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n)
        kin::mb::multibody_env<GRIP, NB, NG, GB, PLANE_MASK, GM, OM, PIN, NS,
                               SM, ND, DM>(st, ctl, prm, out, n, i, n_sub,
                                           iters);
}

// The body of a launch function over the scenes of SCENES: launches the
// scene's kernel on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a scene SCENES does not hold.
#define MB_CASE(...)                                                        \
    if (MB_SCENE_MATCHES(__VA_ARGS__)) {                                    \
        multibody_kernel<MB_SCENE_ARGS(__VA_ARGS__)>                        \
            <<<grid, block, 0, s>>>(st, ctl, prm, out, n, n_sub, iters);    \
        return (int)cudaGetLastError();                                     \
    }
#define MB_LAUNCH(SCENES)                                                   \
    if (n == 0) return 0;                                                   \
    dim3 grid((n + 31) / 32), block(32);                                    \
    cudaStream_t s = (cudaStream_t)stream;                                  \
    SCENES(MB_CASE)                                                         \
    return (int)cudaErrorInvalidValue;
#endif
