// K3's instances for the scenes without a chest with the parallel-jaw
// gripper, and their launch function (the kernel template is
// multibody.cuh; multibody_robotiq.cu holds the block scenes with the
// Robotiq-85).
#include "multibody.cuh"

// The scenes this library holds, as (gripper, bodies, geoms, geom bodies,
// plane mask, geom masks, offset geoms, pinned bodies, statics, static masks,
// door panels, door mask), packed as Plan says: the multi-step scenes of 1-5
// blocks without the chest, with the arm-sphere lanes of end-effector control
// (ops/lane_cull.py) and with every sphere lane (joint control); then the
// push-primitive scenes, the slot (three geoms) and the cube under both
// controls, and the rectangle under end-effector control (under joint control
// it is the 1-block instance, its size a parameter); then insertion, the
// rectangle and the pinned slot (four geoms), under both controls.
#define MULTIBODY_SCENES(X)                                                 \
    X(0, 1, 1, 0x0, 0x40, 0x60, 0x0, 0x0, 0, 0x0, 0, 0x0)                   \
    X(0, 2, 2, 0x10, 0x40, 0x3060, 0x0, 0x0, 0, 0x0, 0, 0x0)                \
    X(0, 3, 3, 0x210, 0x40, 0x1c3870, 0x0, 0x0, 0, 0x0, 0, 0x0)             \
    X(0, 4, 4, 0x3210, 0x40, 0xe1c3870, 0x0, 0x0, 0, 0x0, 0, 0x0)           \
    X(0, 5, 5, 0x43210, 0x40, 0x78f1e3c78, 0x0, 0x0, 0, 0x0, 0, 0x0)        \
    X(0, 1, 1, 0x0, 0x7f, 0x7f, 0x0, 0x0, 0, 0x0, 0, 0x0)                   \
    X(0, 2, 2, 0x10, 0x7f, 0x3fff, 0x0, 0x0, 0, 0x0, 0, 0x0)                \
    X(0, 3, 3, 0x210, 0x7f, 0x1fffff, 0x0, 0x0, 0, 0x0, 0, 0x0)             \
    X(0, 4, 4, 0x3210, 0x7f, 0xfffffff, 0x0, 0x0, 0, 0x0, 0, 0x0)           \
    X(0, 5, 5, 0x43210, 0x7f, 0x7ffffffff, 0x0, 0x0, 0, 0x0, 0, 0x0)        \
    X(0, 2, 4, 0x1000, 0x7c, 0xfffffff, 0x6, 0x0, 0, 0x0, 0, 0x0)           \
    X(0, 2, 4, 0x1000, 0x7f, 0xfffffff, 0x6, 0x0, 0, 0x0, 0, 0x0)           \
    X(0, 1, 1, 0x0, 0x7c, 0x7f, 0x0, 0x0, 0, 0x0, 0, 0x0)                   \
    X(0, 2, 5, 0x11110, 0x7c, 0x7ffffffff, 0x1c, 0x2, 0, 0x0, 0, 0x0)       \
    X(0, 2, 5, 0x11110, 0x7f, 0x7ffffffff, 0x1c, 0x2, 0, 0x0, 0, 0x0)

#ifdef __CUDACC__
// Launch the scene's kernel on `stream`. Returns cudaErrorInvalidValue for a
// scene this library does not hold, else cudaGetLastError() after the launch.
extern "C" int multibody_launch(MB_LAUNCH_PARAMS, const float* st,
                                const float* ctl, const float* prm, float* out,
                                int n, int n_sub, int iters, void* stream) {
    MB_LAUNCH(MULTIBODY_SCENES)
}
#endif
