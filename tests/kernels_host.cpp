// Host build of the port's CUDA kernel sources for the CPU tests
// (tests/test_torch_kernels.py): the per-environment device functions of
// csrc/ik.cu, csrc/engine.cu and csrc/multibody.cu, compiled by the host C++
// compiler, with a loop over environments in place of the CUDA grid. Same C
// interfaces as the CUDA libraries, less the stream.
#include "../pybullet_multigoal_gym_tpu_torch/csrc/engine.cu"
#include "../pybullet_multigoal_gym_tpu_torch/csrc/ik.cu"
#include "../pybullet_multigoal_gym_tpu_torch/csrc/multibody.cu"

extern "C" int ik_host(const float* in, float* out, int n, int num_iters,
                       float tx, float ty, float tz) {
    for (int i = 0; i < n; ++i)
        kin::ik_env(in, out, n, i, num_iters, kin::V3{tx, ty, tz});
    return 0;
}

extern "C" int engine_host(int has_body, int plane_mask, int geom_mask,
                           const float* st, const float* ctl,
                           const float* prm, float* out, int n, int n_sub,
                           int iters) {
#define ENGINE_CASE(HB, PM, GM)                                           \
    if ((has_body != 0) == HB && plane_mask == PM && geom_mask == GM) {   \
        for (int i = 0; i < n; ++i)                                       \
            kin::engine_env<HB, PM, GM>(st, ctl, prm, out, n, i, n_sub,   \
                                        iters);                           \
        return 0;                                                         \
    }
    ENGINE_SCENES(ENGINE_CASE)
#undef ENGINE_CASE
    return 1;
}

extern "C" int multibody_host(int nb, int ng, unsigned geom_bodies,
                              int plane_mask, unsigned long long geom_masks,
                              int offset_geoms, int pinned_bodies,
                              const float* st, const float* ctl,
                              const float* prm, float* out, int n, int n_sub,
                              int iters) {
#define MULTIBODY_CASE(NB, NG, GB, PM, GM, OM, PIN)                       \
    if (nb == NB && ng == NG && geom_bodies == GB && plane_mask == PM &&  \
        geom_masks == GM##ULL && offset_geoms == OM &&                    \
        pinned_bodies == PIN) {                                           \
        for (int i = 0; i < n; ++i)                                       \
            kin::mb::multibody_env<NB, NG, GB, PM, GM##ULL, OM, PIN>(     \
                st, ctl, prm, out, n, i, n_sub, iters);                   \
        return 0;                                                         \
    }
    MULTIBODY_SCENES(MULTIBODY_CASE)
#undef MULTIBODY_CASE
    return 1;
}
