// K1: batched damped-least-squares IK, one thread per environment.
//
// Replaces pybullet_multigoal_gym_tpu/ops/pallas_ik.py:_build_ik_kernel
// (launched through PallasIK.solve). Same math as ops/ik.py:solve, the plain
// PyTorch version it is checked against: each iteration runs the FK chain,
// the tip position error and the rotation-vector orientation error, the 6x7
// Jacobian, A = J J^T + 1e-3 I, two unrolled 6x6 Cholesky solves (the task
// step and the null-space pull toward the rest pose, weight 0.5 over the
// first half of the iterations) and the IK-limit clamp; the joint-limit clamp
// ends the solve.
//
// Bound: operations. Each environment reads 21 and writes 7 floats and does
// about 1.4 thousand operations per iteration (tests/kernels_count.cpp), all
// in registers; the design keeps
// every iteration in registers and lets neighbouring threads read
// neighbouring addresses of the SoA (k, n) input. At 4096 environments one
// thread per environment fills about one warp per SM; spreading an
// environment over several threads is later work.

#include "kin.cuh"

namespace kin {

// Solve A x = b for an SPD 6x6 system by an unrolled Cholesky factorisation,
// pivots clamped at 1e-12 (ops/ik.py:_chol_solve).
KDEV void chol_solve6(float A[6][6], const float b[6], float x[6]) {
    float L[6][6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int j = 0; j <= i; ++j) {
            float s = A[i][j];
#pragma unroll
            for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
            L[i][j] = (i == j) ? sqrtf(fmaxf(s, 1e-12f)) : s / L[j][j];
        }
    }
    float y[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
        float s = b[i];
#pragma unroll
        for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
        y[i] = s / L[i][i];
    }
#pragma unroll
    for (int i = 5; i >= 0; --i) {
        float s = y[i];
#pragma unroll
        for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * x[k];
        x[i] = s / L[i][i];
    }
}

// One environment. in: (21, n) rows = target pos 3, target quat 4 (wxyz),
// rest pose 7, q_init 7; out: (7, n).
KDEV void ik_env(const float* __restrict__ in, float* __restrict__ out, int n,
                 int i, int num_iters, V3 tip_off) {
    V3 tgt = {in[0 * n + i], in[1 * n + i], in[2 * n + i]};
    Q4 tq = {in[3 * n + i], in[4 * n + i], in[5 * n + i], in[6 * n + i]};
    float rest[7], q[7];
#pragma unroll
    for (int j = 0; j < 7; ++j) {
        rest[j] = in[(7 + j) * n + i];
        q[j] = in[(14 + j) * n + i];
    }
#pragma unroll 1
    for (int it = 0; it < num_iters; ++it) {
        V3 o[7];
        Q4 r[7];
        link_frames(q, o, r);
        V3 tip = o[6] + qrotate(r[6], tip_off);
        V3 perr = tgt - tip;
        // orientation error: rotation vector of tq * conj(r7)
        Q4 dq = qmul(tq, qconj(r[6]));
        float s = (dq.w > 0.0f) ? 1.0f : ((dq.w < 0.0f) ? -1.0f : 0.0f);
        dq = {dq.w * s, dq.x * s, dq.y * s, dq.z * s};
        float vnorm = sqrtf(dq.x * dq.x + dq.y * dq.y + dq.z * dq.z);
        float ang = 2.0f * atan2f(vnorm, dq.w);
        float m = fmaxf(vnorm, 1e-12f);
        float err[6] = {perr.x, perr.y, perr.z, dq.x / m * ang,
                        dq.y / m * ang, dq.z / m * ang};
        // Jacobian columns: z_j = r_j ez, Jv_j = z_j x (tip - o_j)
        float J[6][7];
#pragma unroll
        for (int j = 0; j < 7; ++j) {
            V3 z = qrotate(r[j], V3{0.0f, 0.0f, 1.0f});
            V3 jv = cross(z, tip - o[j]);
            J[0][j] = jv.x; J[1][j] = jv.y; J[2][j] = jv.z;
            J[3][j] = z.x; J[4][j] = z.y; J[5][j] = z.z;
        }
        float A[6][6];
#pragma unroll
        for (int a = 0; a < 6; ++a) {
#pragma unroll
            for (int b = 0; b < 6; ++b) {
                float acc = 0.0f;
#pragma unroll
                for (int j = 0; j < 7; ++j) acc = acc + J[a][j] * J[b][j];
                A[a][b] = acc + (a == b ? 1e-3f : 0.0f);
            }
        }
        float y[6], e[7], Je[6], u[6];
        chol_solve6(A, err, y);
        // the null-space pull has weight 0.5 over the first half of the
        // iterations and 0 after: the second half skips its solve
        const bool pull = it < num_iters / 2;
        if (pull) {
#pragma unroll
            for (int j = 0; j < 7; ++j) e[j] = rest[j] - q[j];
#pragma unroll
            for (int a = 0; a < 6; ++a) {
                float acc = 0.0f;
#pragma unroll
                for (int j = 0; j < 7; ++j) acc = acc + J[a][j] * e[j];
                Je[a] = acc;
            }
            chol_solve6(A, Je, u);
        }
#pragma unroll
        for (int j = 0; j < 7; ++j) {
            float dqj = 0.0f;
#pragma unroll
            for (int a = 0; a < 6; ++a) dqj = dqj + J[a][j] * y[a];
            float qj = q[j] + dqj;
            if (pull) {
                float jtu = 0.0f;
#pragma unroll
                for (int a = 0; a < 6; ++a) jtu = jtu + J[a][j] * u[a];
                qj = qj + 0.5f * (e[j] - jtu);
            }
            q[j] = clampf(qj, IK_LO[j], IK_HI[j]);
        }
    }
#pragma unroll
    for (int j = 0; j < 7; ++j) out[j * n + i] = clampf(q[j], JL_LO[j], JL_HI[j]);
}

}  // namespace kin

#ifdef __CUDACC__
__global__ void __launch_bounds__(32)
ik_kernel(const float* __restrict__ in, float* __restrict__ out, int n,
          int num_iters, float tx, float ty, float tz) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) kin::ik_env(in, out, n, i, num_iters, kin::V3{tx, ty, tz});
}

// Launch on `stream`; returns cudaGetLastError() as an int. Blocks of 32
// threads spread 4096 environments over 128 SMs.
extern "C" int ik_launch(const float* in, float* out, int n, int num_iters,
                         float tx, float ty, float tz, void* stream) {
    if (n == 0) return 0;
    ik_kernel<<<(n + 31) / 32, 32, 0, (cudaStream_t)stream>>>(
        in, out, n, num_iters, tx, ty, tz);
    return (int)cudaGetLastError();
}
#endif
