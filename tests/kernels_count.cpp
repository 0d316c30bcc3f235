// Operation count of the port's CUDA kernels on given inputs: the
// per-environment device code of csrc/ik.cu, csrc/engine.cu and K3's
// csrc/multibody.cuh (its instances in multibody.cu, multibody_robotiq.cu,
// chest_push.cu and chest_pick.cu) compiled by
// the host C++ compiler with every `float` replaced by `Flop`, a float that
// counts the arithmetic done on it (tests/kernel_ops.py builds and calls it;
// chip_smoke.py takes the kernels' operation bound from it).
//
// What counts: +, -, *, /, sqrt, sin, cos, atan2, min and max (a clamp is a
// min and a max), once each, when an operand is data. A value is "known"
// when the scene plan or a mask fixes it: a literal, a model table, a lane's
// static metadata, or a 0/1 or +-1 picked from literals by a comparison (an
// activation, a sign). An operation on known values only, a product with a
// known 0 (its result is a known 0), a product or quotient by a known +-1 and
// a sum with a known 0 do not count: they are selects, sign flips and
// masking, not arithmetic the data needs. Comparisons, negation and fabs
// do not count either (the card folds the last two into the operands).
// The values are computed exactly as in the float build, so every branch
// goes as it goes in tests/kernels_host.cpp.
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

static thread_local unsigned long long flop_count = 0;

struct Flop {
    float v;
    bool known;
    Flop() = default;
    constexpr Flop(double x) : v(static_cast<float>(x)), known(true) {}

    static Flop make(float v, bool known) {
        Flop r;
        r.v = v;
        r.known = known;
        return r;
    }
    static Flop counted(float v) {
        ++flop_count;
        return make(v, false);
    }
    bool is(float c) const { return known && v == c; }
    bool unit() const { return is(1.0f) || is(-1.0f); }

    friend Flop operator+(Flop a, Flop b) {
        float v = a.v + b.v;
        if (a.known && b.known) return make(v, true);
        if (a.is(0.0f) || b.is(0.0f)) return make(v, false);
        return counted(v);
    }
    friend Flop operator-(Flop a, Flop b) {
        float v = a.v - b.v;
        if (a.known && b.known) return make(v, true);
        if (a.is(0.0f) || b.is(0.0f)) return make(v, false);
        return counted(v);
    }
    friend Flop operator*(Flop a, Flop b) {
        float v = a.v * b.v;
        if (a.known && b.known) return make(v, true);
        if (a.is(0.0f) || b.is(0.0f)) return make(v, true);
        if (a.unit() || b.unit()) return make(v, false);
        return counted(v);
    }
    friend Flop operator/(Flop a, Flop b) {
        float v = a.v / b.v;
        if (a.known && b.known) return make(v, true);
        if (a.is(0.0f)) return make(v, true);
        if (b.unit()) return make(v, false);
        return counted(v);
    }
    friend Flop operator-(Flop a) { return make(-a.v, a.known); }
    Flop& operator+=(Flop b) { return *this = *this + b; }
    friend bool operator<(Flop a, Flop b) { return a.v < b.v; }
    friend bool operator>(Flop a, Flop b) { return a.v > b.v; }
    friend bool operator<=(Flop a, Flop b) { return a.v <= b.v; }
    friend bool operator>=(Flop a, Flop b) { return a.v >= b.v; }
    friend bool operator==(Flop a, Flop b) { return a.v == b.v; }
    friend bool operator!=(Flop a, Flop b) { return a.v != b.v; }
};

static Flop unary(float v, Flop a) {
    return a.known ? Flop::make(v, true) : Flop::counted(v);
}
static Flop binary(float v, Flop a, Flop b) {
    return a.known && b.known ? Flop::make(v, true) : Flop::counted(v);
}
inline Flop fabsf(Flop a) { return Flop::make(std::fabs(a.v), a.known); }
inline Flop sqrtf(Flop a) { return unary(std::sqrt(a.v), a); }
inline Flop sinf(Flop a) { return unary(::sinf(a.v), a); }
inline Flop cosf(Flop a) { return unary(::cosf(a.v), a); }
inline Flop fminf(Flop a, Flop b) { return binary(std::fmin(a.v, b.v), a, b); }
inline Flop fmaxf(Flop a, Flop b) { return binary(std::fmax(a.v, b.v), a, b); }
inline Flop atan2f(Flop a, Flop b) {
    return binary(::atan2f(a.v, b.v), a, b);
}

#define float Flop
#include "../pybullet_multigoal_gym_tpu_torch/csrc/engine.cu"
#include "../pybullet_multigoal_gym_tpu_torch/csrc/ik.cu"
#include "../pybullet_multigoal_gym_tpu_torch/csrc/multibody.cu"
#include "../pybullet_multigoal_gym_tpu_torch/csrc/multibody_robotiq.cu"
#include "../pybullet_multigoal_gym_tpu_torch/csrc/chest_pick.cu"
#include "../pybullet_multigoal_gym_tpu_torch/csrc/chest_push.cu"
#undef float

namespace {

std::vector<Flop> data(const float* x, long count) {
    std::vector<Flop> out(count);
    for (long k = 0; k < count; ++k) out[k] = Flop::make(x[k], false);
    return out;
}

// Run fn(i) for every environment on `threads` threads; the summed count.
template <class Fn>
unsigned long long count_envs(int n, int threads, Fn fn) {
    if (threads < 1) threads = 1;
    std::vector<unsigned long long> per(threads, 0);
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t)
        pool.emplace_back([&, t] {
            flop_count = 0;
            for (int i = t; i < n; i += threads) fn(i);
            per[t] = flop_count;
        });
    unsigned long long total = 0;
    for (int t = 0; t < threads; ++t) {
        pool[t].join();
        total += per[t];
    }
    return total;
}

void store(const std::vector<Flop>& x, float* out) {
    for (size_t k = 0; k < x.size(); ++k) out[k] = x[k].v;
}

}  // namespace

// Same inputs and outputs as tests/kernels_host.cpp's ik_host; returns the
// operation count over all n environments.
extern "C" unsigned long long ik_count(const float* in, float* out, int n,
                                       int num_iters, float tx, float ty,
                                       float tz, int threads) {
    std::vector<Flop> fin = data(in, 21L * n), fout(7L * n);
    kin::V3 tip = {Flop::make(tx, false), Flop::make(ty, false),
                   Flop::make(tz, false)};
    unsigned long long ops = count_envs(n, threads, [&](int i) {
        kin::ik_env(fin.data(), fout.data(), n, i, num_iters, tip);
    });
    store(fout, out);
    return ops;
}

// Same inputs and outputs as engine_host; returns the operation count over
// all n environments, or ~0 for a scene the library does not hold.
extern "C" unsigned long long engine_count(int grip, int body,
                                           int plane_mask, int geom_mask,
                                           const float* st, const float* ctl,
                                           const float* prm, float* out,
                                           int n, int n_sub, int iters,
                                           int threads) {
    std::vector<Flop> fst = data(st, 34L * n), fctl = data(ctl, 9L * n),
                      fprm = data(prm, kin::N_PARAMS), fout(34L * n);
#define ENGINE_CASE(G, B, PM, GM)                                            \
    if (grip == G && body == B && plane_mask == PM && geom_mask == GM) {     \
        unsigned long long ops = count_envs(n, threads, [&](int i) {         \
            kin::engine_env<G, B, PM, GM>(fst.data(), fctl.data(),           \
                                          fprm.data(), fout.data(), n, i,    \
                                          n_sub, iters);                     \
        });                                                                  \
        store(fout, out);                                                    \
        return ops;                                                          \
    }
    ENGINE_SCENES(ENGINE_CASE)
#undef ENGINE_CASE
    return ~0ULL;
}

// The K3 scenes counted here: those whose bound chip_smoke.py reports
// (block_rearrange with 2 blocks, block_stack with 5, the push-primitive
// slot and cube, insertion, chest_push with 4 blocks, and block_rearrange
// with 2 blocks and the Robotiq-85, end-effector control; packed as in
// multibody.cu); each instance of the counting float takes seconds to
// compile.
#define MULTIBODY_COUNTED(X)                                                \
    X(0, 2, 2, 0x10, 0x40, 0x3060, 0x0, 0x0, 0, 0x0, 0, 0x0)                \
    X(0, 5, 5, 0x43210, 0x40, 0x78f1e3c78, 0x0, 0x0, 0, 0x0, 0, 0x0)        \
    X(0, 2, 4, 0x1000, 0x7c, 0xfffffff, 0x6, 0x0, 0, 0x0, 0, 0x0)           \
    X(0, 2, 5, 0x11110, 0x7c, 0x7ffffffff, 0x1c, 0x2, 0, 0x0, 0, 0x0)       \
    X(0, 4, 4, 0x3210, 0x40, 0xf1e3c78, 0x0, 0x0, 3, 0x1c3870, 2, 0x70)     \
    X(1, 2, 2, 0x10, 0x40, 0x3060, 0x0, 0x0, 0, 0x0, 0, 0x0)

// Same inputs and outputs as tests/kernels_host.cpp's multibody_host;
// returns the operation count over all n environments, or ~0 for a scene
// this build does not count.
extern "C" unsigned long long multibody_count(
    MB_LAUNCH_PARAMS, const float* st, const float* ctl, const float* prm,
    float* out, int n_prm, int n, int n_sub, int iters, int threads) {
    const long rows = 18 + 13L * nb + 5;
    std::vector<Flop> fst = data(st, rows * n),
                      fctl = data(ctl, (long)kin::mb::N_CTRL * n),
                      fprm = data(prm, n_prm), fout(rows * n);
#define MULTIBODY_CASE(...)                                                 \
    if (MB_SCENE_MATCHES(__VA_ARGS__)) {                                    \
        unsigned long long ops = count_envs(n, threads, [&](int i) {        \
            kin::mb::multibody_env<MB_SCENE_ARGS(__VA_ARGS__)>(             \
                fst.data(), fctl.data(), fprm.data(), fout.data(), n, i,    \
                n_sub, iters);                                              \
        });                                                                 \
        store(fout, out);                                                   \
        return ops;                                                         \
    }
    MULTIBODY_COUNTED(MULTIBODY_CASE)
#undef MULTIBODY_CASE
    return ~0ULL;
}
