// K3's instances with the Robotiq-85 gripper, and their launch function
// (the kernel template is multibody.cuh; multibody.cu holds the same
// scenes with the parallel jaw), built into a library of its own so that
// it compiles beside the other three.
#include "multibody.cuh"

// The scenes this library holds, packed as in multibody.cu: the multi-step
// scenes of 1-5 blocks without the chest, with the arm-sphere lanes of
// end-effector control (ops/lane_cull.py) and with every sphere lane (joint
// control). The primitives', insertion's and the chest's scenes with the
// Robotiq-85 are not built: the envs raise for them.
#define MULTIBODY_ROBOTIQ_SCENES(X)                                         \
    X(1, 1, 1, 0x0, 0x40, 0x60, 0x0, 0x0, 0, 0x0, 0, 0x0)                   \
    X(1, 2, 2, 0x10, 0x40, 0x3060, 0x0, 0x0, 0, 0x0, 0, 0x0)                \
    X(1, 3, 3, 0x210, 0x40, 0x1c3870, 0x0, 0x0, 0, 0x0, 0, 0x0)             \
    X(1, 4, 4, 0x3210, 0x40, 0xe1c3870, 0x0, 0x0, 0, 0x0, 0, 0x0)           \
    X(1, 5, 5, 0x43210, 0x40, 0x78f1e3c78, 0x0, 0x0, 0, 0x0, 0, 0x0)        \
    X(1, 1, 1, 0x0, 0x7f, 0x7f, 0x0, 0x0, 0, 0x0, 0, 0x0)                   \
    X(1, 2, 2, 0x10, 0x7f, 0x3fff, 0x0, 0x0, 0, 0x0, 0, 0x0)                \
    X(1, 3, 3, 0x210, 0x7f, 0x1fffff, 0x0, 0x0, 0, 0x0, 0, 0x0)             \
    X(1, 4, 4, 0x3210, 0x7f, 0xfffffff, 0x0, 0x0, 0, 0x0, 0, 0x0)           \
    X(1, 5, 5, 0x43210, 0x7f, 0x7ffffffff, 0x0, 0x0, 0, 0x0, 0, 0x0)

#ifdef __CUDACC__
// Launch the scene's kernel on `stream`. Returns cudaErrorInvalidValue for a
// scene this library does not hold, else cudaGetLastError() after the launch.
extern "C" int multibody_robotiq_launch(MB_LAUNCH_PARAMS, const float* st,
                                        const float* ctl, const float* prm,
                                        float* out, int n, int n_sub,
                                        int iters, void* stream) {
    MB_LAUNCH(MULTIBODY_ROBOTIQ_SCENES)
}
#endif
