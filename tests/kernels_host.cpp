// Host build of the port's CUDA kernel sources for the CPU tests
// (tests/test_torch_kernels.py): the per-environment device functions of
// csrc/ik.cu, csrc/engine.cu and K3's csrc/multibody.cu,
// csrc/multibody_robotiq.cu, csrc/chest_push.cu and csrc/chest_pick.cu
// (their template in csrc/multibody.cuh), compiled by the host C++
// compiler, with a loop over environments in place of the CUDA grid. Same C
// interfaces as the CUDA libraries, less the stream.
#include "../pybullet_multigoal_gym_tpu_torch/csrc/engine.cu"
#include "../pybullet_multigoal_gym_tpu_torch/csrc/ik.cu"
#include "../pybullet_multigoal_gym_tpu_torch/csrc/multibody.cu"
#include "../pybullet_multigoal_gym_tpu_torch/csrc/multibody_robotiq.cu"
#include "../pybullet_multigoal_gym_tpu_torch/csrc/chest_pick.cu"
#include "../pybullet_multigoal_gym_tpu_torch/csrc/chest_push.cu"

extern "C" int ik_host(const float* in, float* out, int n, int num_iters,
                       float tx, float ty, float tz) {
    for (int i = 0; i < n; ++i)
        kin::ik_env(in, out, n, i, num_iters, kin::V3{tx, ty, tz});
    return 0;
}

extern "C" int engine_host(int grip, int body, int plane_mask,
                           int geom_mask, const float* st, const float* ctl,
                           const float* prm, float* out, int n, int n_sub,
                           int iters) {
#define ENGINE_CASE(G, B, PM, GM)                                         \
    if (grip == G && body == B && plane_mask == PM && geom_mask == GM) {  \
        for (int i = 0; i < n; ++i)                                       \
            kin::engine_env<G, B, PM, GM>(st, ctl, prm, out, n, i, n_sub, \
                                          iters);                         \
        return 0;                                                         \
    }
    ENGINE_SCENES(ENGINE_CASE)
#undef ENGINE_CASE
    return 1;
}

extern "C" int multibody_host(MB_LAUNCH_PARAMS, const float* st,
                              const float* ctl, const float* prm, float* out,
                              int n, int n_sub, int iters) {
#define MULTIBODY_CASE(...)                                               \
    if (MB_SCENE_MATCHES(__VA_ARGS__)) {                                  \
        for (int i = 0; i < n; ++i)                                       \
            kin::mb::multibody_env<MB_SCENE_ARGS(__VA_ARGS__)>(           \
                st, ctl, prm, out, n, i, n_sub, iters);                   \
        return 0;                                                         \
    }
    MULTIBODY_SCENES(MULTIBODY_CASE)
    MULTIBODY_ROBOTIQ_SCENES(MULTIBODY_CASE)
    CHEST_PUSH_SCENES(MULTIBODY_CASE)
    CHEST_PICK_SCENES(MULTIBODY_CASE)
#undef MULTIBODY_CASE
    return 1;
}
