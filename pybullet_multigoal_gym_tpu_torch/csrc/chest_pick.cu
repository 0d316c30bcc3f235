// K3's instances for chest_pick_and_place, and their launch function (the
// kernel template is multibody.cuh; chest_push.cu holds chest_push's and
// multibody.cu the scenes without a chest, each built into a library of its
// own so that the three compile at once).
#include "multibody.cuh"

// The scenes this library holds, packed as in multibody.cu:
// chest_pick_and_place's chest (four walls under the up_sliding lid of two
// panels) with 1-5 blocks, each with the arm-sphere lanes of end-effector
// control (ops/lane_cull.py) and with every sphere lane (joint control).
#define CHEST_PICK_SCENES(X)                                                \
    X(0, 1, 1, 0x0, 0x40, 0x7c, 0x0, 0x0, 4, 0xe1c3870, 2, 0x70)            \
    X(0, 2, 2, 0x10, 0x40, 0x3e7c, 0x0, 0x0, 4, 0xe1c3870, 2, 0x70)         \
    X(0, 3, 3, 0x210, 0x40, 0x1f3e7c, 0x0, 0x0, 4, 0xe1c3870, 2, 0x70)      \
    X(0, 4, 4, 0x3210, 0x40, 0xf9f3e7c, 0x0, 0x0, 4, 0xe1c3870, 2, 0x70)    \
    X(0, 5, 5, 0x43210, 0x40, 0x7cf9f3e7c, 0x0, 0x0, 4, 0xe1c3870, 2, 0x70) \
    X(0, 1, 1, 0x0, 0x7f, 0x7f, 0x0, 0x0, 4, 0xfffffff, 2, 0x7f)            \
    X(0, 2, 2, 0x10, 0x7f, 0x3fff, 0x0, 0x0, 4, 0xfffffff, 2, 0x7f)         \
    X(0, 3, 3, 0x210, 0x7f, 0x1fffff, 0x0, 0x0, 4, 0xfffffff, 2, 0x7f)      \
    X(0, 4, 4, 0x3210, 0x7f, 0xfffffff, 0x0, 0x0, 4, 0xfffffff, 2, 0x7f)    \
    X(0, 5, 5, 0x43210, 0x7f, 0x7ffffffff, 0x0, 0x0, 4, 0xfffffff, 2, 0x7f)

#ifdef __CUDACC__
// Launch the scene's kernel on `stream`. Returns cudaErrorInvalidValue for a
// scene this library does not hold, else cudaGetLastError() after the launch.
extern "C" int chest_pick_launch(MB_LAUNCH_PARAMS, const float* st,
                                 const float* ctl, const float* prm, float* out,
                                 int n, int n_sub, int iters, void* stream) {
    MB_LAUNCH(CHEST_PICK_SCENES)
}
#endif
