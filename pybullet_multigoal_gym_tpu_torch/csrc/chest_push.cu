// K3's instances for chest_push, and their launch function (the kernel
// template is multibody.cuh; chest_pick.cu holds chest_pick_and_place's and
// multibody.cu the scenes without a chest, each built into a library of its
// own so that the three compile at once).
#include "multibody.cuh"

// The scenes this library holds, packed as in multibody.cu: chest_push's
// chest (three walls and the front_sliding door of two panels, the fourth
// wall) with 1-5 blocks, each with the arm-sphere lanes of end-effector
// control (ops/lane_cull.py) and with every sphere lane (joint control).
#define CHEST_PUSH_SCENES(X)                                                \
    X(0, 1, 1, 0x0, 0x40, 0x78, 0x0, 0x0, 3, 0x1c3870, 2, 0x70)             \
    X(0, 2, 2, 0x10, 0x40, 0x3c78, 0x0, 0x0, 3, 0x1c3870, 2, 0x70)          \
    X(0, 3, 3, 0x210, 0x40, 0x1e3c78, 0x0, 0x0, 3, 0x1c3870, 2, 0x70)       \
    X(0, 4, 4, 0x3210, 0x40, 0xf1e3c78, 0x0, 0x0, 3, 0x1c3870, 2, 0x70)     \
    X(0, 5, 5, 0x43210, 0x40, 0x78f1e3c78, 0x0, 0x0, 3, 0x1c3870, 2, 0x70)  \
    X(0, 1, 1, 0x0, 0x7f, 0x7f, 0x0, 0x0, 3, 0x1fffff, 2, 0x7f)             \
    X(0, 2, 2, 0x10, 0x7f, 0x3fff, 0x0, 0x0, 3, 0x1fffff, 2, 0x7f)          \
    X(0, 3, 3, 0x210, 0x7f, 0x1fffff, 0x0, 0x0, 3, 0x1fffff, 2, 0x7f)       \
    X(0, 4, 4, 0x3210, 0x7f, 0xfffffff, 0x0, 0x0, 3, 0x1fffff, 2, 0x7f)     \
    X(0, 5, 5, 0x43210, 0x7f, 0x7ffffffff, 0x0, 0x0, 3, 0x1fffff, 2, 0x7f)

#ifdef __CUDACC__
// Launch the scene's kernel on `stream`. Returns cudaErrorInvalidValue for a
// scene this library does not hold, else cudaGetLastError() after the launch.
extern "C" int chest_push_launch(MB_LAUNCH_PARAMS, const float* st,
                                 const float* ctl, const float* prm, float* out,
                                 int n, int n_sub, int iters, void* stream) {
    MB_LAUNCH(CHEST_PUSH_SCENES)
}
#endif
