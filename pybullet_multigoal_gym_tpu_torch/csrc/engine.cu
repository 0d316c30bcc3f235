// K2: the whole control step (n_substeps velocity-level 2 ms substeps)
// fused into one launch, one thread per environment.
//
// Replaces pybullet_multigoal_gym_tpu/ops/pallas_engine.py:_build_kernel
// (launched through PallasEngine.control_step) for the no-object scene, the
// one-free-box scene and the one-free-cylinder scene (slide's puck), with the
// parallel-jaw gripper or the Robotiq-85 (the pads' kinematics and the finger
// constants: kin.cuh's finger_frames and Grip). Same physics as
// ops/engine_plain.py, the plain PyTorch version it is checked against: arm
// and finger servos, gravity, FK, the contact lanes (box-plane corners or the
// cylinder's 4 rim points, finger-box SAT manifolds or the finger-cylinder
// lateral and vertical lanes, finger-plane corners, the arm-sphere lanes kept
// by ops/lane_cull.py, which see the cylinder as a box; their geometry is in
// lanes.cuh, shared with K3), an 8-iteration mass-splitting Jacobi solve with
// Baumgarte bias and a friction clamp, frozen-arm joint coupling, integration
// and the EE contact-force readback.
//
// Design. As on the TPU, the state stays on chip for the whole control step:
// nothing goes back to device memory between substeps. The state and
// controls are read once, as SoA (rows, n) arrays so that neighbouring
// threads read neighbouring addresses, and the state is written once. The
// scene is a template (the gripper; its body: none, a box or a cylinder;
// which arm spheres keep a plane / a body lane), so the lane list is
// static, like the Python-built Pallas kernel.
// The lane arrays (about 40 floats per lane, 33 lanes for push) do not fit
// in registers and live in per-thread local memory, which the L1/L2 caches
// hold at these sizes.
//
// The solver's work follows the data: a lane that is not in contact takes no
// impulse, so the setup, the iterations and the arm coupling skip it.
//
// Bound: operations (a few thousand per environment and substep, as
// tests/kernels_count.cpp counts them, against 77 floats of traffic per
// environment and step). At 4096 environments one thread per environment is
// about one warp per SM, far below what the card holds; spreading an
// environment's lanes over a warp is later work.

#include "lanes.cuh"

namespace kin {

// The body of a scene (ops/cuda_engine.py:scene_key).
enum { BODY_NONE = 0, BODY_BOX = 1, BODY_CYL = 2 };

// Scene parameters, in the order of ops/cuda_engine.py:scene_params; a
// cylinder's radius is P_HX and its half length P_HZ.
enum {
    P_PLANE_Z, P_PLANE_FRIC, P_PLANE_MU, P_FINGER_MU, P_BODY_FRIC,
    P_HX, P_HY, P_HZ, P_INV_MASS, P_IIX, P_IIY, P_IIZ, P_ERP_DT, P_SLOP,
    N_PARAMS
};

// state rows: q 7, qd 7, fq 2, fqd 2, body pos 3, quat 4, linvel 3,
// angvel 3, ee force 3; controls rows: q target 7, finger target 2
enum { R_Q = 0, R_QD = 7, R_FQ = 14, R_FQD = 16, R_BP = 18, R_BQ = 21,
       R_BV = 25, R_BW = 28, R_EE = 31, N_ROWS = 34 };
enum { C_QT = 0, C_FT = 7 };

constexpr int popc7(int m) {
    return (m & 1) + (m >> 1 & 1) + (m >> 2 & 1) + (m >> 3 & 1) +
           (m >> 4 & 1) + (m >> 5 & 1) + (m >> 6 & 1);
}

template <int BODY, int PLANE_MASK, int GEOM_MASK>
struct Plan {
    // box-plane 4 + finger-box SAT 2 x 9, or cylinder-plane 4 + finger-
    // cylinder 2 x 2; finger-plane 2 x 4, arm spheres
    static constexpr bool HAS_BODY = BODY != BODY_NONE;
    static constexpr int L = (BODY == BODY_BOX ? 4 + 18 : 0) +
                             (BODY == BODY_CYL ? 4 + 4 : 0) + 8 +
                             popc7(PLANE_MASK) +
                             (HAS_BODY ? popc7(GEOM_MASK) : 0);
};

// Contact lanes of one substep plus their static solver metadata
// (pallas_engine.py:_Lane).
template <int L>
struct Lanes {
    V3 pt[L], nrm[L];
    float pen[L], act[L];
    float mu[L], bsg[L], fsg[L], asg[L], cpl[L], esg[L];
    int fid[L], lnk[L];
    int count = 0;

    KDEV void add(V3 p, V3 n, float pe, float ac, float m, float bs, int fi,
                  float fs, int lk, float as, float cp, float es) {
        int l = count++;
        pt[l] = p; nrm[l] = n; pen[l] = pe; act[l] = ac; mu[l] = m;
        bsg[l] = bs; fid[l] = fi; fsg[l] = fs; lnk[l] = lk; asg[l] = as;
        cpl[l] = cp; esg[l] = es;
    }
};

// One environment, n_sub substeps.
template <int GRIP, int BODY, int PLANE_MASK, int GEOM_MASK>
KDEV void engine_env(const float* __restrict__ st, const float* __restrict__ ctl,
                     const float* __restrict__ prm, float* __restrict__ out,
                     int n, int i, int n_sub, int iters) {
    constexpr bool HAS_BODY = Plan<BODY, PLANE_MASK, GEOM_MASK>::HAS_BODY;
    constexpr int L = Plan<BODY, PLANE_MASK, GEOM_MASK>::L;
    const float plane_z = prm[P_PLANE_Z], plane_fric = prm[P_PLANE_FRIC];
    const float plane_mu = prm[P_PLANE_MU], finger_mu = prm[P_FINGER_MU];
    const float body_fric = prm[P_BODY_FRIC], inv_mass = prm[P_INV_MASS];
    const float half[3] = {prm[P_HX], prm[P_HY], prm[P_HZ]};
    const float inv_I[3] = {prm[P_IIX], prm[P_IIY], prm[P_IIZ]};
    const float erp_dt = prm[P_ERP_DT], slop = prm[P_SLOP];
    using G = Grip<GRIP>;
    const float fhalf[3] = {G::half(0), G::half(1), G::half(2)};

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
    V3 bp = {st[R_BP * n + i], st[(R_BP + 1) * n + i], st[(R_BP + 2) * n + i]};
    Q4 bq = {st[R_BQ * n + i], st[(R_BQ + 1) * n + i], st[(R_BQ + 2) * n + i],
             st[(R_BQ + 3) * n + i]};
    V3 bv = {st[R_BV * n + i], st[(R_BV + 1) * n + i], st[(R_BV + 2) * n + i]};
    V3 bw = {st[R_BW * n + i], st[(R_BW + 1) * n + i], st[(R_BW + 2) * n + i]};
    V3 ee = {0.0f, 0.0f, 0.0f};

    Lanes<L> ls;
    V3 t1[L], t2[L], r_a[L], v_arm[L], lax[L];
    float kn[L], kt1[L], kt2[L], bias[L], solv[L], lfc[L];
    float ln[L], lt1[L], lt2[L];

#pragma unroll 1
    for (int s = 0; s < n_sub; ++s) {
        // 1. arm servo -> proposed qd (q integrates after the solve)
#pragma unroll
        for (int j = 0; j < 7; ++j) {
            float v_des = clampf(ARM_SERVO_RATE * (qt[j] - q[j]), -ARM_VEL_LIMIT,
                                 ARM_VEL_LIMIT);
            float dv = ARM_PD_FORCE * DT / ARM_INERTIA[j];
            qd[j] = qd[j] + clampf(v_des - qd[j], -dv, dv);
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
            float dv = G::force() * DT / G::mass();
            fqd[f] = fqd[f] + clampf(v_des - fqd[f], -dv, dv);
        }
        // 4. gravity
        M3 Ra = qmat(bq);
        if (HAS_BODY) bv.z = bv.z - GRAVITY * DT;

        // 5. contact lanes, in the order of pallas_engine.py:573-611
        ls.count = 0;
        if (BODY == BODY_BOX) {
            box_plane_lanes(bp, Ra, half, plane_z,
                            [&](V3 p, V3 nl, float pen, float act) {
                                ls.add(p, nl, pen, act, plane_mu, 1.0f, -1,
                                       0.0f, -1, 0.0f, 0.0f, 0.0f);
                            });
#pragma unroll
            for (int f = 0; f < 2; ++f)
                sat_box_box_lanes(bp, Ra, half, fpos[f], Rb7, fhalf,
                                  [&](V3 p, V3 nl, float pen, float act) {
                                      ls.add(p, nl, pen, act, finger_mu, 1.0f,
                                             f, -1.0f, 6, -1.0f, 0.0f, -1.0f);
                                  });
        }
        if (BODY == BODY_CYL) {
            // the pad is side B, the puck side A (pallas_engine.py:583-590)
            cyl_plane_lanes(bp, bq, half[0], half[2], plane_z,
                            [&](V3 p, V3 nl, float pen, float act) {
                                ls.add(p, nl, pen, act, plane_mu, 1.0f, -1,
                                       0.0f, -1, 0.0f, 0.0f, 0.0f);
                            });
#pragma unroll
            for (int f = 0; f < 2; ++f)
                box_cyl_lanes(fpos[f], Rb7, fhalf, bp, half[0], half[2],
                              [&](V3 p, V3 nl, float pen, float act) {
                                  ls.add(p, nl, pen, act, finger_mu, 1.0f, f,
                                         -1.0f, 6, -1.0f, 0.0f, -1.0f);
                              });
        }
#pragma unroll
        for (int f = 0; f < 2; ++f)
            box_plane_lanes(fpos[f], Rb7, fhalf, plane_z,
                            [&](V3 p, V3 nl, float pen, float act) {
                                ls.add(p, nl, pen, act, plane_fric, 0.0f, f,
                                       1.0f, 6, 1.0f, 1.0f, 1.0f);
                            });
#pragma unroll
        for (int sp = 0; sp < 7; ++sp) {
            const bool keep_plane = (PLANE_MASK >> sp) & 1;
            const bool keep_box = HAS_BODY && ((GEOM_MASK >> sp) & 1);
            if (!keep_plane && !keep_box) continue;
            int li = SPH_LINK[sp];
            float rad = SPH_R[sp];
            float es = li == 6 ? 1.0f : 0.0f;
            V3 c = o[li] + qrotate(r[li], load3(SPH_OFF[sp]));
            if (keep_plane)
                sphere_plane_lane(c, rad, plane_z,
                                  [&](V3 p, V3 nl, float pen, float act) {
                                      ls.add(p, nl, pen, act, 0.5f * plane_fric,
                                             0.0f, -1, 0.0f, li, 1.0f, 1.0f,
                                             es);
                                  });
            if (keep_box)
                sphere_box_lane(c, rad, bp, Ra, half,
                                [&](V3 p, V3 nl, float pen, float act) {
                                    ls.add(p, nl, pen, act, 0.5f * body_fric,
                                           -1.0f, -1, 0.0f, li, 1.0f, 1.0f,
                                           es);
                                });
        }

        // 6. solve (fused Jacobi, mass splitting)
        M3 Iw;
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int k = 0; k < 3; ++k)
                Iw.m[a][k] = Ra.m[a][0] * inv_I[0] * Ra.m[k][0] +
                             Ra.m[a][1] * inv_I[1] * Ra.m[k][1] +
                             Ra.m[a][2] * inv_I[2] * Ra.m[k][2];
        float body_count = 0.0f, fin_count[2] = {0.0f, 0.0f}, arm_count = 0.0f;
#pragma unroll 1
        for (int l = 0; l < L; ++l) {
            body_count += ls.act[l] * fabsf(ls.bsg[l]);
            if (ls.fid[l] == 0) fin_count[0] += ls.act[l];
            if (ls.fid[l] == 1) fin_count[1] += ls.act[l];
            if (ls.cpl[l] > 0.0f) arm_count += ls.act[l];
        }
        body_count = fmaxf(body_count, 1.0f);
        fin_count[0] = fmaxf(fin_count[0], 1.0f);
        fin_count[1] = fmaxf(fin_count[1], 1.0f);
        arm_count = fmaxf(arm_count, 1.0f);

        // An inactive lane takes no impulse: its multipliers stay 0, so the
        // setup, the iterations and the coupling skip it (adding its zero
        // impulses would leave every sum as it is).
#pragma unroll 1
        for (int l = 0; l < L; ++l) {
            ln[l] = lt1[l] = lt2[l] = 0.0f;
            solv[l] = 0.0f;
            if (!(ls.act[l] > 0.0f)) continue;
            V3 nl = ls.nrm[l], p = ls.pt[l];
            r_a[l] = p - bp;
            V3 up = fabsf(nl.z) < 0.9f ? V3{0.0f, 0.0f, 1.0f} : V3{1.0f, 0.0f, 0.0f};
            V3 a1 = cross(nl, up);
            a1 = a1 * rsq(fmaxf(dot(a1, a1), 1e-18f));
            t1[l] = a1;
            t2[l] = cross(nl, a1);
            int fi = ls.fid[l];
            lax[l] = fi == 0 ? faxis[0] : (fi == 1 ? faxis[1] : V3{0.0f, 0.0f, 0.0f});
            lfc[l] = fi == 0 ? fin_count[0] : (fi == 1 ? fin_count[1] : 1.0f);
            // frozen arm point velocity sum_j qd_j (z_j x (p - o_j))
            V3 va = {0.0f, 0.0f, 0.0f};
            for (int j = 0; j <= ls.lnk[l]; ++j)
                va = va + cross(z[j], p - o[j]) * qd[j];
            v_arm[l] = va;
            // split-mass effective inverse masses along n, t1, t2
            float k3[3];
#pragma unroll
            for (int dir = 0; dir < 3; ++dir) {
                V3 d = dir == 0 ? nl : (dir == 1 ? t1[l] : t2[l]);
                float k = 0.0f;
                if (fi >= 0) {
                    float da = dot(d, lax[l]);
                    k = (da * da / G::mass()) * lfc[l];
                }
                if (ls.cpl[l] > 0.0f) {
                    // arm yields: J_j . d = z_j . ((p - o_j) x d)
                    float ka = 0.0f;
                    for (int j = 0; j <= ls.lnk[l]; ++j) {
                        float jd = dot(cross(p - o[j], d), z[j]);
                        ka = ka + jd * jd * (1.0f / ARM_INERTIA[j]);
                    }
                    k = k + ka * arm_count;
                }
                if (HAS_BODY && ls.bsg[l] != 0.0f) {
                    V3 rxd = cross(r_a[l], d);
                    k = k + (inv_mass + dot(rxd, mat3vec(Iw, rxd))) * body_count;
                }
                k3[dir] = k;
            }
            solv[l] = k3[0] > 1e-8f ? 1.0f : 0.0f;
            kn[l] = fmaxf(k3[0], 1e-8f);
            kt1[l] = fmaxf(k3[1], 1e-8f);
            kt2[l] = fmaxf(k3[2], 1e-8f);
            // capped recovery velocity
            bias[l] = -fminf(erp_dt * fmaxf(ls.pen[l] - slop, 0.0f), BIAS_CAP);
        }

        V3 bv_ = bv, bw_ = bw;
        float fqd_[2] = {fqd[0], fqd[1]};
#pragma unroll 1
        for (int it = 0; it < iters; ++it) {
            V3 sum_imp = {0.0f, 0.0f, 0.0f}, sum_ang = {0.0f, 0.0f, 0.0f};
            float dfq[2] = {0.0f, 0.0f};
#pragma unroll 1
            for (int l = 0; l < L; ++l) {
                if (!(solv[l] > 0.0f)) continue;
                int fi = ls.fid[l];
                // signed relative velocity va - vb of the lane
                V3 v = v_arm[l] * ls.asg[l];
                if (fi >= 0) v = v + (lax[l] * fqd_[fi]) * ls.fsg[l];
                if (HAS_BODY && ls.bsg[l] != 0.0f)
                    v = v + (bv_ + cross(bw_, r_a[l])) * ls.bsg[l];
                float dln = -(dot(v, ls.nrm[l]) + bias[l]) / kn[l];
                float nln = fmaxf(ln[l] + dln, 0.0f);
                dln = nln - ln[l];
                float lim = ls.mu[l] * nln;
                float d1 = -dot(v, t1[l]) / kt1[l];
                float n1 = clampf(lt1[l] + d1, -lim, lim);
                d1 = n1 - lt1[l];
                float d2 = -dot(v, t2[l]) / kt2[l];
                float n2 = clampf(lt2[l] + d2, -lim, lim);
                d2 = n2 - lt2[l];
                ln[l] = nln; lt1[l] = n1; lt2[l] = n2;
                V3 imp = ls.nrm[l] * dln + t1[l] * d1 + t2[l] * d2;
                if (HAS_BODY && ls.bsg[l] != 0.0f) {
                    V3 imp_b = imp * ls.bsg[l];
                    sum_imp = sum_imp + imp_b;
                    sum_ang = sum_ang + cross(r_a[l], imp_b);
                }
                if (fi >= 0)
                    dfq[fi] = dfq[fi] + dot(imp, lax[l]) * ls.fsg[l] / G::mass();
            }
            if (HAS_BODY) {
                bv_ = bv_ + sum_imp * inv_mass;
                bw_ = bw_ + mat3vec(Iw, sum_ang);
            }
            fqd_[0] = fqd_[0] + dfq[0];
            fqd_[1] = fqd_[1] + dfq[1];
        }

        // arm coupling: accumulated impulses -> joint velocities, once,
        // capped at the motor's per-substep authority; EE force sensor
        float jd[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        V3 fin_imp = {0.0f, 0.0f, 0.0f};
#pragma unroll 1
        for (int l = 0; l < L; ++l) {
            if (!(solv[l] > 0.0f)) continue;
            V3 tot = ls.nrm[l] * ln[l] + t1[l] * lt1[l] + t2[l] * lt2[l];
            fin_imp = fin_imp + tot * ls.esg[l];
            V3 imp_arm = tot * ls.asg[l];
            for (int j = 0; j <= ls.lnk[l]; ++j)
                jd[j] = jd[j] + dot(cross(ls.pt[l] - o[j], imp_arm), z[j]);
        }
#pragma unroll
        for (int j = 0; j < 7; ++j) {
            float inv = 1.0f / ARM_INERTIA[j];
            float cap = ARM_PD_FORCE * DT * inv;
            qd[j] = qd[j] + clampf(jd[j] * inv, -cap, cap);
        }
        ee = {fin_imp.x / DT, fin_imp.y / DT, fin_imp.z / DT};

        // 7. integrate; joints at a hard stop lose the velocity into it
#pragma unroll
        for (int j = 0; j < 7; ++j) {
            q[j] = clampf(q[j] + qd[j] * DT, JL_LO[j], JL_HI[j]);
            if ((q[j] >= JL_HI[j] && qd[j] > 0.0f) ||
                (q[j] <= JL_LO[j] && qd[j] < 0.0f))
                qd[j] = 0.0f;
        }
        if (HAS_BODY) {
            bp = bp + bv_ * DT;
            float w_norm = sqrtf(fmaxf(dot(bw_, bw_), 1e-18f));
            float half_ang = w_norm * DT * 0.5f;
            float sc = w_norm > 1e-9f ? sinf(half_ang) / w_norm : 0.0f;
            Q4 dq = {cosf(half_ang), bw_.x * sc, bw_.y * sc, bw_.z * sc};
            bq = qnormalize(qmul(dq, bq));
            bv = bv_;
            bw = bw_;
        }
#pragma unroll
        for (int f = 0; f < 2; ++f) {
            fq[f] = clampf(fq[f] + fqd_[f] * DT, G::lo(), G::hi());
            fqd[f] = ((fq[f] >= G::hi() && fqd_[f] > 0.0f) ||
                      (fq[f] <= G::lo() && fqd_[f] < 0.0f))
                         ? 0.0f : fqd_[f];
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
    const float body[13] = {bp.x, bp.y, bp.z, bq.w, bq.x, bq.y, bq.z,
                            bv.x, bv.y, bv.z, bw.x, bw.y, bw.z};
#pragma unroll
    for (int k = 0; k < 13; ++k) out[(R_BP + k) * n + i] = body[k];
    out[R_EE * n + i] = ee.x;
    out[(R_EE + 1) * n + i] = ee.y;
    out[(R_EE + 2) * n + i] = ee.z;
}

}  // namespace kin

// The scenes this library holds, as (gripper, body, plane mask, body mask):
// reach, push (pick_and_place) and slide with the arm-sphere lanes of
// end-effector control, and each with every sphere lane (joint control),
// with the parallel jaw and then with the Robotiq-85.
#define ENGINE_SCENES(X)                                                    \
    X(0, 0, 0x40, 0x00) X(0, 1, 0x40, 0x60) X(0, 0, 0x7f, 0x00)             \
    X(0, 1, 0x7f, 0x7f) X(0, 2, 0x40, 0x78) X(0, 2, 0x7f, 0x7f)             \
    X(1, 0, 0x40, 0x00) X(1, 1, 0x40, 0x60) X(1, 0, 0x7f, 0x00)             \
    X(1, 1, 0x7f, 0x7f) X(1, 2, 0x40, 0x78) X(1, 2, 0x7f, 0x7f)

#ifdef __CUDACC__
template <int GRIP, int BODY, int PLANE_MASK, int GEOM_MASK>
__global__ void __launch_bounds__(32)
engine_kernel(const float* __restrict__ st, const float* __restrict__ ctl,
              const float* __restrict__ prm, float* __restrict__ out, int n,
              int n_sub, int iters) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n)
        kin::engine_env<GRIP, BODY, PLANE_MASK, GEOM_MASK>(st, ctl, prm, out,
                                                            n, i, n_sub, iters);
}

// Launch the scene's kernel on `stream`. Returns cudaErrorInvalidValue for a
// scene this library does not hold, else cudaGetLastError() after the launch.
extern "C" int engine_launch(int grip, int body, int plane_mask, int geom_mask,
                             const float* st, const float* ctl,
                             const float* prm, float* out, int n, int n_sub,
                             int iters, void* stream) {
    if (n == 0) return 0;
    dim3 grid((n + 31) / 32), block(32);
    cudaStream_t s = (cudaStream_t)stream;
#define ENGINE_CASE(G, B, PM, GM)                                            \
    if (grip == G && body == B && plane_mask == PM && geom_mask == GM) {     \
        engine_kernel<G, B, PM, GM><<<grid, block, 0, s>>>(                  \
            st, ctl, prm, out, n, n_sub, iters);                             \
        return (int)cudaGetLastError();                                      \
    }
    ENGINE_SCENES(ENGINE_CASE)
#undef ENGINE_CASE
    return (int)cudaErrorInvalidValue;
}
#endif
