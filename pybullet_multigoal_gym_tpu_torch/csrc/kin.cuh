// Device code shared by the IK kernel (ik.cu) and the control-step kernel
// (engine.cu): the Kuka iiwa14 model constants, small vector / quaternion
// algebra and the 7-joint FK chain. Counterpart of the tile algebra of
// pybullet_multigoal_gym_tpu/ops/pallas_engine.py:50-115 and the FK chain
// shared by pallas_engine.py:124 and pallas_ik.py:72.
//
// Every function works on one environment; the kernels map one thread to one
// environment. The constants are the float64 values of model/kuka_model.py
// (and ops/fk.py's origin quaternions), rounded to float32 as the PyTorch
// path rounds them; tests/test_torch_model.py checks that they agree.
//
// Compiled by nvcc for the card; the same source also compiles as plain C++
// (KDEV = inline), which tests/kernels_host.cpp uses to check the kernels'
// arithmetic on a host without a card.
#pragma once

#ifdef __CUDACC__
#define KDEV __device__ __forceinline__
#define KTABLE __constant__ const
#else
#include <cmath>
#define KDEV inline
#define KTABLE static const
#endif

namespace kin {

// ------------------------------------------------------------------ model
KTABLE float OXYZ[7][3] = {
    {0.0, 0.0, 0.1575},
    {0.0, 0.0, 0.2025},
    {0.0, 0.2045, 0.0},
    {0.0, 0.0, 0.2155},
    {0.0, 0.1845, 0.0},
    {0.0, 0.0, 0.2155},
    {0.0, 0.081, 0.0}};
KTABLE float OQ[7][4] = {
    {1.0, 0.0, 0.0, 0.0},
    {4.329780281177467e-17, 4.329780281177466e-17, 0.7071067811865475, 0.7071067811865476},
    {4.329780281177467e-17, 4.329780281177466e-17, 0.7071067811865475, 0.7071067811865476},
    {0.7071067811865476, 0.7071067811865475, 0.0, 0.0},
    {4.329780281177467e-17, -4.329780281177466e-17, 0.7071067811865476, 0.7071067811865475},
    {0.7071067811865476, 0.7071067811865475, 0.0, 0.0},
    {4.329780281177467e-17, -4.329780281177466e-17, 0.7071067811865476, 0.7071067811865475}};
KTABLE float JL_LO[7] = {-2.96705972839, -2.09439510239, -2.96705972839, -2.09439510239, -2.96705972839, -2.09439510239, -3.05432619099};
KTABLE float JL_HI[7] = {2.96705972839, 2.09439510239, 2.96705972839, 2.09439510239, 2.96705972839, 2.09439510239, 3.05432619099};
KTABLE float IK_LO[7] = {-0.967, -2.0, -2.96, 0.19, -2.96, -2.09, -3.05};
KTABLE float IK_HI[7] = {0.967, 2.0, 2.96, 2.29, 2.96, 2.09, 3.05};
KTABLE float ARM_INERTIA[7] = {1.8, 1.8, 0.9, 0.9, 0.25, 0.12, 0.05};
KTABLE int SPH_LINK[7] = {3, 3, 4, 4, 5, 6, 6};
KTABLE float SPH_OFF[7][3] = {
    {0.0, 0.0, 0.0},
    {0.0, 0.09225, 0.0},
    {0.0, 0.0, 0.0},
    {0.0, 0.0, 0.10775},
    {0.0, 0.0, 0.0},
    {0.0, 0.0, 0.0},
    {0.0, 0.0, 0.055}};
KTABLE float SPH_R[7] = {0.065, 0.06, 0.06, 0.055, 0.055, 0.043, 0.028};
KTABLE float GRIPPER_BASE_OFFSET[3] = {0.0, 0.0, 0.055};
KTABLE float FINGER_ORIGIN[2][3] = {{0.0, 0.04, 0.04}, {0.0, -0.04, 0.04}};
KTABLE float FINGER_AXIS[2][3] = {{0.0, -1.0, 0.0}, {0.0, 1.0, 0.0}};
KTABLE float FINGER_HALF[3] = {0.0125, 0.005, 0.04};

// scalars (ops/dynamics.py)
constexpr float FINGER_LIMIT = 0.035f;
constexpr float FINGER_MASS = 1.9108530000000001f;  // mass x inertia scaling
constexpr float FINGER_PD_FORCE = 50.0f;
constexpr float ARM_PD_FORCE = 200.0f;
constexpr float DT = 0.002f;
constexpr float GRAVITY = 9.81f;
constexpr float ARM_SERVO_RATE = 15.0f;   // position gain 0.03 / DT
constexpr float ARM_VEL_LIMIT = 10.0f;
constexpr float FINGER_VEL_LIMIT = 0.2f;
constexpr float BIAS_CAP = 0.15f;

// the Robotiq-85 (model/kuka_model.py:105-163): the mimic linkage's
// lengths in the gripper base's plane, the base's offset along link 7's z,
// the pad box's half extents in link 7's axes, and the closure DoF's range,
// reflected inertia (kg m^2), drive and velocity limit
KTABLE float ROBOTIQ_PAD_HALF[3] = {0.011, 0.0055, 0.018};
constexpr float ROBOTIQ_INNER_X = 0.06142f;
constexpr float ROBOTIQ_INNER_Y = 0.0127f;
constexpr float ROBOTIQ_ARM_TX = 0.04303959807f;
constexpr float ROBOTIQ_ARM_TY = 0.03759940821f;
constexpr float ROBOTIQ_TAB_X = 0.05f;
constexpr float ROBOTIQ_TAB_Y = 0.0075f;
constexpr float ROBOTIQ_BASE_Z = 0.045f;
constexpr float ROBOTIQ_JOINT_LIMIT = 0.804f;
constexpr float ROBOTIQ_FINGER_INERTIA = 0.006241079977051787f;
constexpr float ROBOTIQ_PD_FORCE = 50.0f;
constexpr float ROBOTIQ_VEL_LIMIT = 2.0f;

// ---------------------------------------------------------------- algebra
struct V3 { float x, y, z; };
struct Q4 { float w, x, y, z; };
struct M3 { float m[3][3]; };   // rows

KDEV V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
KDEV V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
KDEV V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
KDEV V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
KDEV V3 operator*(float s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
KDEV float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
KDEV V3 cross(V3 a, V3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}
KDEV V3 load3(const float (&a)[3]) { return {a[0], a[1], a[2]}; }
KDEV float clampf(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }
KDEV float sgnf(float x) { return x >= 0.0f ? 1.0f : -1.0f; }
KDEV float rsq(float x) {
#ifdef __CUDACC__
    return rsqrtf(x);
#else
    return 1.0f / sqrtf(x);
#endif
}

KDEV Q4 qmul(Q4 a, Q4 b) {
    return {a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
            a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
            a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
            a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}

KDEV Q4 qconj(Q4 q) { return {q.w, -q.x, -q.y, -q.z}; }

KDEV V3 qrotate(Q4 q, V3 v) {
    V3 u = {q.x, q.y, q.z};
    V3 uv = cross(u, v);
    return v + 2.0f * (q.w * uv + cross(u, uv));
}

KDEV M3 qmat(Q4 q) {
    float w = q.w, x = q.x, y = q.y, z = q.z;
    M3 r;
    r.m[0][0] = 1 - 2 * (y * y + z * z);
    r.m[0][1] = 2 * (x * y - z * w);
    r.m[0][2] = 2 * (x * z + y * w);
    r.m[1][0] = 2 * (x * y + z * w);
    r.m[1][1] = 1 - 2 * (x * x + z * z);
    r.m[1][2] = 2 * (y * z - x * w);
    r.m[2][0] = 2 * (x * z - y * w);
    r.m[2][1] = 2 * (y * z + x * w);
    r.m[2][2] = 1 - 2 * (x * x + y * y);
    return r;
}

KDEV V3 col(const M3& R, int k) { return {R.m[0][k], R.m[1][k], R.m[2][k]}; }

KDEV V3 mat3vec(const M3& R, V3 v) {
    return {R.m[0][0] * v.x + R.m[0][1] * v.y + R.m[0][2] * v.z,
            R.m[1][0] * v.x + R.m[1][1] * v.y + R.m[1][2] * v.z,
            R.m[2][0] * v.x + R.m[2][1] * v.y + R.m[2][2] * v.z};
}

KDEV Q4 qnormalize(Q4 q) {
    float s = rsq(fmaxf(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z, 1e-12f));
    return {q.w * s, q.x * s, q.y * s, q.z * s};
}

// --------------------------------------------------------------------- FK
// World origins o[j] and rotations r[j] of the 7 joint frames
// (ops/fk.py:link_frames).
KDEV void link_frames(const float q[7], V3 o[7], Q4 r[7]) {
    V3 p = {0.0f, 0.0f, 0.0f};
    Q4 rr = {1.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 7; ++j) {
        p = p + qrotate(rr, load3(OXYZ[j]));
        rr = qmul(rr, Q4{OQ[j][0], OQ[j][1], OQ[j][2], OQ[j][3]});
        float h = q[j] * 0.5f;
        rr = qmul(rr, Q4{cosf(h), 0.0f, 0.0f, sinf(h)});
        o[j] = p;
        r[j] = rr;
    }
}

// ---------------------------------------------------------------- gripper
// The gripper is the first template integer of K2 and K3.
enum { GRIP_JAW = 0, GRIP_ROBOTIQ = 1 };

// A gripper's finger constants (ops/dynamics.py:finger_consts): the pad
// box's half extents, the finger DoF's inertia (kg for the jaw's slide,
// kg m^2 about the Robotiq's closure angle), its drive, velocity limit and
// joint range.
template <int GRIP> struct Grip {
    static KDEV float half(int k) { return FINGER_HALF[k]; }
    static KDEV float mass() { return FINGER_MASS; }
    static KDEV float force() { return FINGER_PD_FORCE; }
    static KDEV float vel_limit() { return FINGER_VEL_LIMIT; }
    static KDEV float lo() { return -FINGER_LIMIT; }
    static KDEV float hi() { return FINGER_LIMIT; }
};
template <> struct Grip<GRIP_ROBOTIQ> {
    static KDEV float half(int k) { return ROBOTIQ_PAD_HALF[k]; }
    static KDEV float mass() { return ROBOTIQ_FINGER_INERTIA; }
    static KDEV float force() { return ROBOTIQ_PD_FORCE; }
    static KDEV float vel_limit() { return ROBOTIQ_VEL_LIMIT; }
    static KDEV float lo() { return 0.0f; }
    static KDEV float hi() { return ROBOTIQ_JOINT_LIMIT; }
};

// The pad box centres fpos and the pads' velocity per unit finger rate
// faxis, from link 7's origin o7 and rotation r7 and the finger joints fq
// (pallas_engine.py:fk_chain, :149-165). The parallel jaw's pads slide
// along their unit axes from the gripper base. The Robotiq's hang from
// link 7's origin on the parallelogram linkage; their velocity carries
// m/rad and is not a unit vector. The sums run in the Pallas kernel's
// order, as ops/fk.py:robotiq_pads has them.
template <int GRIP>
KDEV void finger_frames(V3 o7, Q4 r7, const float fq[2], V3 fpos[2],
                        V3 faxis[2]) {
    if constexpr (GRIP == GRIP_ROBOTIQ) {
#pragma unroll
        for (int f = 0; f < 2; ++f) {
            float s = f == 0 ? 1.0f : -1.0f;
            float ct = cosf(fq[f]), st = sinf(fq[f]);
            float pad_x = ROBOTIQ_INNER_X + ROBOTIQ_ARM_TX * ct +
                          ROBOTIQ_ARM_TY * st + ROBOTIQ_TAB_X + ROBOTIQ_BASE_Z;
            float pad_y = s * (ROBOTIQ_INNER_Y + ROBOTIQ_ARM_TY * ct -
                               ROBOTIQ_ARM_TX * st - ROBOTIQ_TAB_Y +
                               ROBOTIQ_PAD_HALF[1]);
            float dx = -ROBOTIQ_ARM_TX * st + ROBOTIQ_ARM_TY * ct;
            float dy = -s * (ROBOTIQ_ARM_TX * ct + ROBOTIQ_ARM_TY * st);
            fpos[f] = o7 + qrotate(r7, V3{0.0f, pad_y, pad_x});
            faxis[f] = qrotate(r7, V3{0.0f, dy, dx});
        }
    } else {
        V3 gbase = o7 + qrotate(r7, load3(GRIPPER_BASE_OFFSET));
#pragma unroll
        for (int f = 0; f < 2; ++f) {
            V3 ax = load3(FINGER_AXIS[f]);
            fpos[f] = gbase + qrotate(r7, load3(FINGER_ORIGIN[f]) + ax * fq[f]);
            faxis[f] = qrotate(r7, ax);
        }
    }
}

}  // namespace kin
