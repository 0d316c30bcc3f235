"""The port's CUDA kernels against their plain PyTorch versions.

The tests marked ``cuda`` need a CUDA device and skip elsewhere; the file
imports no JAX, so that it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

The tests on ``host_kernels`` build the kernels' per-environment device
code with the host C++ compiler (tests/kernels_host.cpp) and hold it against
the plain versions on the CPU, so that the kernel sources' arithmetic is
checked where there is no card. Host libm and the CPU plain version round
differently from the card, and the box of the 'drop' state lands flat, where
an axis choice is a tie: after 2 substeps, within 1e-4 rad for K1 and 2e-3
for K2 (the JAX package's engine bound; EE force 2e-3 / dt).

Tolerances on the card, at the main path's 4096 envs: K1 1e-4 rad (the
kernel sums in another order than the plain version). K2 and K3 on the main
path's own inputs: every env within 1e-4 after 2 substeps and within 2e-3
after 100, the bound the JAX package holds its Pallas engines to against its
XLA engine. K2 and K3 on the stress states, whose impulses run to thousands
of newtons: there the plain version's own answer moves by far more than
rounding in some envs when rounding moves by one ulp (a contact test or a
joint stop flips). Each env agrees within the tolerance (1e-4 after 2
substeps, 2e-3 after 100) or within twice its own spread over 8 plain runs
with 1-ulp noise in every substep (tests/torch_common.py:plain_run),
whichever is larger. In K3's block piles as many envs may lie beyond that,
and as far, as a noisy plain run lies beyond the other runs' bound
(`noise_bound`); on K3's main path an env may part by more than the
tolerance only where the noisy runs do, and then stays within its bound.
"""

import ctypes
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from pybullet_multigoal_gym_tpu_torch import make_vec_env
from pybullet_multigoal_gym_tpu_torch.model import kuka_model as KM
from pybullet_multigoal_gym_tpu_torch.ops import (_build, cuda_engine, cuda_ik,
                                                 cuda_multibody)
from pybullet_multigoal_gym_tpu_torch.ops import dynamics as D
from pybullet_multigoal_gym_tpu_torch.ops import engine_plain as EP
from pybullet_multigoal_gym_tpu_torch.ops import ik
from pybullet_multigoal_gym_tpu_torch.ops import multibody_plain as MP
from pybullet_multigoal_gym_tpu_torch.ops import scene as S
from pybullet_multigoal_gym_tpu_torch.ops.cuda_engine import CudaEngine
from pybullet_multigoal_gym_tpu_torch.ops.cuda_ik import CudaIK
from pybullet_multigoal_gym_tpu_torch.ops.cuda_multibody import (
    CudaMultiBodyEngine)
from tests import kernel_ops
from tests.torch_common import (ARM_FIELDS, BODY_FIELDS, ROBOTIQ_KINDS,
                                SLIDE_KINDS, chest_inputs, cuda,  # noqa: F401
                                inputs, insertion_inputs, multi_inputs, n,
                                noise_bound, plain_run, plain_trajectory,
                                primitive_inputs, robotiq_inputs,
                                slide_inputs, t, torch_controls, torch_state,
                                workspace_targets)

torch.set_num_threads(1)

N = 4096
N_HOST = 256
HOST_SRC = Path(__file__).resolve().parent / 'kernels_host.cpp'
# unoptimised: 2 s to build instead of 7-12 s, and the same float arithmetic
# (no FMA contraction; SSE floats round as the card's do)
HOST_FLAGS = ['-std=c++17', '-O0', '-ffp-contract=off', '-shared', '-fPIC']


def env_errors(out, ref, fields):
    """Per-env max |out - ref| over the state ``fields`` (numpy, (n,))."""
    count = out.q.shape[0]
    return np.max([np.abs(n(getattr(out, f)) - n(getattr(ref, f)))
                   .reshape(count, -1).max(1) for f in fields], axis=0)


# ------------------------------------------------------ host build, CPU
@pytest.fixture(scope='module')
def host_kernels():
    """The kernel sources built for the host (no FMA contraction, as on the
    card); skips where there is no C++ compiler."""
    if not (shutil.which('g++') or shutil.which('c++')):
        pytest.skip('needs a host C++ compiler')
    so = ctypes.CDLL(str(kernel_ops.host_library(HOST_SRC, HOST_FLAGS)))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.ik_host.argtypes = [P, P, I, I, F, F, F]
    so.engine_host.argtypes = [I, I, I, I, P, P, P, P, I, I, I]
    so.multibody_host.argtypes = [I, I, I, ctypes.c_uint, I,
                                  ctypes.c_ulonglong, I, I, I, ctypes.c_uint,
                                  I, I, P, P, P, P, I, I, I]
    for fn in (so.ik_host, so.engine_host, so.multibody_host):
        fn.restype = ctypes.c_int
    return so


@pytest.mark.parametrize('iters', [8, 40])
def test_ik_source_on_host_matches_plain(host_kernels, iters):
    rng = np.random.default_rng(2)
    tgt = t(workspace_targets(rng, N_HOST))
    q0 = t(np.asarray(KM.KUKA_REST_POSE, np.float32)
           + rng.uniform(-0.2, 0.2, (N_HOST, 7)))
    packed = cuda_ik.pack(tgt, q_init=q0)
    out = torch.empty((7, N_HOST))
    assert host_kernels.ik_host(packed.data_ptr(), out.data_ptr(), N_HOST,
                                iters, *CudaIK().tip_offset) == 0
    np.testing.assert_allclose(n(out.t()), n(ik.solve(tgt, q_init=q0,
                                                      num_iters=iters)),
                               atol=1e-4)


@pytest.mark.parametrize('task', ['push', 'reach'])
@pytest.mark.parametrize('control', ['ee', 'joint'])
@pytest.mark.parametrize('kind', ['drop', 'contact'])
def test_engine_source_on_host_matches_plain(host_kernels, task, control,
                                             kind):
    """Each scene the kernel library holds, 2 substeps."""
    _engine_host_vs_plain(host_kernels, task, control, kind)


def test_engine_source_on_host_matches_plain_sphere_plane(host_kernels):
    """The push joint-control scene with a wrist or elbow sphere on the
    table: the sphere-plane lanes act."""
    _engine_host_vs_plain(host_kernels, 'push', 'joint', 'sphere')


def slide_scene(kind):
    """Slide's scene for a stress state of `slide_inputs`: joint control
    (every arm-sphere lane) for 'sphere', EE control for the rest."""
    return D.scene_consts(S.single_step_scene(True, 'long_table'),
                          ik_workspace=kind != 'sphere')


@pytest.mark.parametrize('kind', SLIDE_KINDS)
def test_engine_source_on_host_matches_plain_slide(host_kernels, kind):
    """The two slide instances (the cylinder branch; EE control and, for
    the 'sphere' state, joint control), 2 substeps, on slide's stress
    states; the lane group the state is made for acts."""
    want = {'tilt': 'cyl-plane', 'strike': 'finger-cyl lateral',
            'cap': 'finger-cyl vertical', 'sphere': 'sphere-box'}
    sc = slide_scene(kind)
    st, ctl = slide_inputs(kind, N_HOST, seed=1)
    active = _engine_host_vs_plain(host_kernels, 'slide', sc, kind, (st, ctl))
    if kind in want:
        assert active[want[kind]] > 0.25, active


def _engine_host_vs_plain(host_kernels, task, control, kind, given=None):
    """K2's host build against its plain version after 2 substeps: the
    task's scene under ``control`` ('ee' or 'joint', or the scene itself),
    on ``inputs``' state ``kind`` or on ``given``. Returns the plain run's
    lane groups' shares."""
    has_obj = task != 'reach'
    sc = control if isinstance(control, D.SceneConsts) else D.scene_consts(
        S.single_step_scene(has_obj), ik_workspace=control == 'ee')
    st, ctl = given or inputs(has_obj, kind, N_HOST, seed=1)
    st, ctl = torch_state(st), torch_controls(ctl)
    rows, ctl_rows = cuda_engine.pack(st, ctl)
    prm = torch.tensor(cuda_engine.scene_params(sc), dtype=torch.float32)
    out = torch.empty_like(rows)
    assert host_kernels.engine_host(
        *cuda_engine.scene_key(sc), rows.data_ptr(),
        ctl_rows.data_ptr(), prm.data_ptr(), out.data_ptr(), N_HOST, 2,
        sc.solver_iters) == 0
    out = cuda_engine.unpack(out, st)
    ref, active = plain_run(sc, st, ctl, 2)
    fields = ARM_FIELDS + (BODY_FIELDS if has_obj else ())
    assert env_errors(out, ref, fields).max() <= 2e-3
    np.testing.assert_allclose(n(out.ee_contact_force),
                               n(ref.ee_contact_force), atol=2e-3 / D.DT_SUB)
    if kind == 'contact':
        assert np.abs(n(out.ee_contact_force)).max() > 1.0
    if kind == 'sphere' and task != 'slide':
        assert active['sphere-plane'] > 0.5
    return active


def _multibody_host(host_kernels, sc, st, ctl, n_sub):
    rows, ctl_rows = cuda_multibody.pack(st, ctl)
    prm = torch.tensor(cuda_multibody.scene_params(sc), dtype=torch.float32)
    out = torch.empty_like(rows)
    assert host_kernels.multibody_host(
        *cuda_multibody.scene_key(sc), rows.data_ptr(), ctl_rows.data_ptr(),
        prm.data_ptr(), out.data_ptr(), rows.shape[1], n_sub,
        sc.solver_iters) == 0
    return cuda_multibody.unpack(out, sc.nb)


@pytest.mark.parametrize('nb', [1, 2, 3, 4, 5])
@pytest.mark.parametrize('kind', ['drop', 'contact', 'sphere'])
def test_multibody_source_on_host_matches_plain(host_kernels, nb, kind):
    """K3's scenes of block_rearrange and block_stack, 1-5 blocks, 2
    substeps: EE control on the drop and contact states, joint control
    with a wrist or elbow sphere on the table."""
    sc = D.multibody_consts(S.multi_step_scene(nb),
                            ik_workspace=kind != 'sphere')
    st, ctl = multi_inputs(nb, kind, N_HOST // 2, seed=1)
    # (a single dropped block is still falling after 2 substeps)
    want = {'drop': ('box-plane',) if nb > 1 else (),
            'contact': ('finger-box',) + (('box-box',) if nb > 1 else ()),
            'sphere': ('sphere-plane',)}[kind]
    _multibody_host_vs_plain(host_kernels, sc, st, ctl, want)


def _multibody_host_vs_plain(host_kernels, sc, st, ctl, want):
    """The host build of K3 against its plain version, 2 substeps; the lane
    groups ``want`` act. The door's state passes through a scene without a
    door."""
    st, ctl = torch_state(st), torch_controls(ctl)
    out = _multibody_host(host_kernels, sc, st, ctl, 2)
    ref, active = plain_run(sc, st, ctl, 2)
    fields = ARM_FIELDS + BODY_FIELDS + (('door_q', 'door_qd') if sc.nd
                                         else ())
    assert env_errors(out, ref, fields).max() <= 2e-3
    np.testing.assert_allclose(n(out.ee_contact_force),
                               n(ref.ee_contact_force), atol=2e-3 / D.DT_SUB)
    if not sc.nd:
        np.testing.assert_array_equal(n(out.door_q), n(st.door_q))
    assert all(active.get(g, 0.0) > 0 for g in want), active


# the push-primitive scenes' checks: (objects, state, control)
PRIMITIVE_CASES = [(('slot', 'cube'), 'drop', 'ee'),
                   (('slot', 'cube'), 'press', 'ee'),
                   (('slot', 'cube'), 'drop', 'joint'),
                   (('rectangle',), 'drop', 'ee'),
                   (('rectangle',), 'drop', 'joint')]


@pytest.mark.parametrize('keys,kind,control', PRIMITIVE_CASES)
def test_multibody_source_on_host_matches_plain_multi_geom(
        host_kernels, keys, kind, control):
    """K3's push-primitive scenes (bodies of several box geoms and sizes),
    2 substeps: the objects dropped onto the plate, and the pads pushing
    the cube into the slot's mouth."""
    sc = D.multibody_consts(S.shape_assemble_scene(keys),
                            ik_workspace=control == 'ee')
    st, ctl = primitive_inputs(keys, kind, N_HOST // 2, seed=1)
    want = {'drop': ('box-plane',),
            'press': ('box-box', 'finger-box')}[kind]
    _multibody_host_vs_plain(host_kernels, sc, st, ctl, want)


@pytest.mark.parametrize('kind,control', [('drop', 'ee'), ('load', 'ee'),
                                          ('slot_pressed', 'ee'),
                                          ('drop', 'joint')])
def test_multibody_source_on_host_matches_plain_pinned(host_kernels, kind,
                                                       control):
    """K3's insertion scene (a free rectangle and a pinned slot of four
    geoms), 2 substeps: the rectangle dropped beside the slot, resting on
    its mouth between the squeezing pads, and driven toward its base bar
    with a wrist sphere on its end bar."""
    sc = D.multibody_consts(S.insertion_scene(), ik_workspace=control == 'ee')
    st, ctl = insertion_inputs(kind, N_HOST // 2, seed=1)
    want = {'drop': ('box-plane',),
            'load': ('box-pinned', 'finger-box', 'finger-pinned'),
            'slot_pressed': ('sphere-pinned',)}[kind]
    _multibody_host_vs_plain(host_kernels, sc, st, ctl, want)


# the chest scenes' checks: (door, state, control), with the lane groups
# that act in them (tests/torch_common.py:chest_inputs)
CHEST_WANT = {'drop': ('box-static',), 'handle': ('finger-door',),
              'door_block': ('box-door', 'finger-box', 'finger-door'),
              'hold_open': ('finger-static', 'sphere-static'),
              'spawn': ('box-plane',)}
CHEST_CASES = [(door, kind, 'ee') for door in ('front_sliding', 'up_sliding')
               for kind in CHEST_WANT] + [('front_sliding', 'handle', 'joint'),
                                          ('up_sliding', 'door_block', 'joint')]


@pytest.mark.parametrize('door,kind,control', CHEST_CASES)
def test_multibody_source_on_host_matches_plain_chest(host_kernels, door,
                                                      kind, control):
    """K3's chest scenes (static walls and a prismatic door) with 2 blocks,
    2 substeps, on each chest stress state: the door's state too, and the
    lane groups of the state act."""
    sc = D.multibody_consts(S.multi_step_scene(2, True, door),
                            ik_workspace=control == 'ee')
    st, ctl = chest_inputs(door, 2, kind, N_HOST // 4, seed=1)
    _multibody_host_vs_plain(host_kernels, sc, st, ctl, CHEST_WANT[kind])


def robotiq_scene(task, control):
    """The scene of a single-step task with the Robotiq-85 under
    ``control``."""
    spec = S.single_step_scene(task != 'reach', 'long_table' if task == 'slide'
                               else 'table')
    return D.scene_consts(spec, ik_workspace=control == 'ee',
                          gripper='robotiq85')


# K2's Robotiq instances on the host: (task, control, state); each of the 6
# instances on a state of tests/torch_common.py:robotiq_inputs
ROBOTIQ_ENGINE_CASES = [('push', 'ee', kind) for kind in ROBOTIQ_KINDS[:3]] + [
    ('push', 'joint', 'sphere'), ('reach', 'ee', 'pad_table'),
    ('reach', 'joint', 'sphere'), ('slide', 'ee', 'grasp'),
    ('slide', 'joint', 'sphere')]


@pytest.mark.parametrize('task,control,kind', ROBOTIQ_ENGINE_CASES)
def test_engine_source_on_host_matches_plain_robotiq(host_kernels, task,
                                                      control, kind):
    """K2's Robotiq-85 instances (the linkage's pads, their short box, the
    closure DoF's inertia, drive and [0, 0.804] stops): the pads closing on
    a block or a puck, driven into both stops, pressed on the table, and a
    wrist sphere on the table under joint control; the lane group each
    state is made for acts."""
    st, ctl = robotiq_inputs(kind, N_HOST, seed=1)
    active = _engine_host_vs_plain(host_kernels, task,
                                   robotiq_scene(task, control), kind,
                                   (st, ctl))
    want = {'grasp': 'finger-plane', 'pad_table': 'finger-plane',
            'sphere': 'sphere-plane'}.get(kind)
    if want is not None and task != 'slide':
        assert active[want] > 0.1, active


@pytest.mark.parametrize('nb', [1, 2, 3, 4, 5])
@pytest.mark.parametrize('control', ['ee', 'joint'])
def test_multibody_source_on_host_matches_plain_robotiq(host_kernels, nb,
                                                        control):
    """K3's Robotiq-85 instances, 1-5 blocks, 2 substeps: under EE control
    the pads closing on a block (1, 3 and 5 blocks) or squeezing the top
    block of a pile (2 and 4), under joint control a wrist or elbow sphere
    on the table."""
    sc = D.multibody_consts(S.multi_step_scene(nb),
                            ik_workspace=control == 'ee', gripper='robotiq85')
    kind = 'sphere' if control == 'joint' else ('pile' if nb % 2 == 0
                                                else 'grasp')
    st, ctl = robotiq_inputs(kind, N_HOST // 2, seed=1, nb=nb)
    want = {'grasp': ('box-plane',), 'pile': ('box-box',),
            'sphere': ('sphere-plane',)}[kind]
    _multibody_host_vs_plain(host_kernels, sc, st, ctl, want)


def _scene_table(name):
    """The instances of a kernel library's scene table macro, as tuples of
    strings: (gripper, body, plane mask, body mask) for engine.cu,
    (gripper, bodies, geoms, geom bodies, plane mask, geom masks, offset
    geoms, pinned bodies, statics, static masks, door panels, door mask)
    for K3's libraries."""
    text = (_build.CSRC / (name + '.cu')).read_text()
    macro = {'engine': 'ENGINE_SCENES', 'multibody': 'MULTIBODY_SCENES',
             'multibody_robotiq': 'MULTIBODY_ROBOTIQ_SCENES',
             'chest_push': 'CHEST_PUSH_SCENES',
             'chest_pick': 'CHEST_PICK_SCENES'}[name]
    table = text[text.index('#define ' + macro):]
    table = table[:table.index('\n\n')]
    return set(tuple(x.strip() for x in args.split(','))
               for args in re.findall(r'X\(([^)]*)\)', table))


@pytest.mark.parametrize('task', ['reach', 'push', 'pick_and_place',
                                  'slide'])
@pytest.mark.parametrize('joint_control', [False, True])
def test_engine_library_holds_every_scene(task, joint_control):
    """The (gripper, body, plane mask, body mask) of every scene the envs
    build (`cuda_engine.scene_key`; ops/lane_cull.py decides the masks) is
    one `ENGINE_SCENES` instance of engine.cu: a missing one would fail
    only at launch, on the card."""
    held = {tuple(int(x, 0) for x in key) for key in _scene_table('engine')}
    assert len(held) == 12
    sc = make_vec_env(num_envs=1, task=task, joint_control=joint_control,
                      device='cpu').core.scene
    assert cuda_engine.scene_key(sc) in held


@pytest.mark.parametrize('task', ['block_rearrange', 'block_stack',
                                  'primitive_push_assemble',
                                  'primitive_push_reach', 'insertion'])
@pytest.mark.parametrize('joint_control', [False, True])
def test_multibody_library_holds_every_scene(task, joint_control):
    """The structure (`cuda_multibody.scene_key`) of every scene the
    multi-step envs build, 1-5 blocks, the push-primitive envs and the
    insertion env build is one `MULTIBODY_SCENES` instance of multibody.cu:
    a missing one would fail only at launch, on the card."""
    held = {tuple(int(x, 0) for x in key)
            for key in _scene_table('multibody')}
    assert len(held) == 15
    if task == 'insertion':
        env = make_vec_env(num_envs=1, task=task, joint_control=joint_control,
                           device='cpu')
        specs = [S.insertion_scene()]
        assert env.core.scene == D.multibody_consts(
            specs[0], ik_workspace=not joint_control)
    elif task.startswith('primitive'):
        env = make_vec_env(num_envs=1, task=task, primitive='discrete_push',
                           joint_control=joint_control, device='cpu')
        specs = [S.shape_assemble_scene(env.cfg.manipulated_object_keys)]
    else:
        env = make_vec_env(num_envs=1, task=task, num_block=2,
                           joint_control=joint_control, device='cpu')
        specs = [S.multi_step_scene(nb) for nb in range(1, 6)]
        assert env.core.scene == D.multibody_consts(
            S.multi_step_scene(2), ik_workspace=not joint_control)
    for spec in specs:
        sc = D.multibody_consts(spec, ik_workspace=not joint_control)
        assert cuda_multibody.scene_key(sc) in held
        assert cuda_multibody.library(sc) == 'multibody'


@pytest.mark.parametrize('task', ['chest_push', 'chest_pick_and_place'])
@pytest.mark.parametrize('joint_control', [False, True])
def test_chest_library_holds_every_scene(task, joint_control):
    """The structure of every scene the chest envs build, 1-5 blocks, is
    one instance of the task's own library (`CHEST_PUSH_SCENES` of
    chest_push.cu, `CHEST_PICK_SCENES` of chest_pick.cu)."""
    lib = {'chest_push': 'chest_push',
           'chest_pick_and_place': 'chest_pick'}[task]
    held = {tuple(int(x, 0) for x in key) for key in _scene_table(lib)}
    assert len(held) == 10
    env = make_vec_env(num_envs=1, task=task, num_block=2,
                       joint_control=joint_control, device='cpu')
    door = env.cfg.chest_door
    assert env.core.scene == D.multibody_consts(
        S.multi_step_scene(2, True, door), ik_workspace=not joint_control)
    for nb in range(1, 6):
        sc = D.multibody_consts(S.multi_step_scene(nb, True, door),
                                ik_workspace=not joint_control)
        assert cuda_multibody.scene_key(sc) in held
        assert cuda_multibody.library(sc) == lib


@pytest.mark.parametrize('joint_control', [False, True])
def test_robotiq_libraries_hold_every_scene(joint_control):
    """Every scene the Robotiq-85 envs build is an instance: the
    single-step tasks' of engine.cu (gripper 1), block_stack's and
    block_rearrange's, 1-5 blocks, of multibody_robotiq.cu."""
    engine = {tuple(int(x, 0) for x in key) for key in _scene_table('engine')}
    held = {tuple(int(x, 0) for x in key)
            for key in _scene_table('multibody_robotiq')}
    assert len(held) == 10
    for task in ('reach', 'push', 'pick_and_place', 'slide'):
        sc = make_vec_env(num_envs=1, task=task, gripper='robotiq85',
                          joint_control=joint_control,
                          device='cpu').core.scene
        assert cuda_engine.scene_key(sc)[0] == 1
        assert cuda_engine.scene_key(sc) in engine
    for task in ('block_rearrange', 'block_stack'):
        env = make_vec_env(num_envs=1, task=task, num_block=2,
                           gripper='robotiq85', joint_control=joint_control,
                           device='cpu')
        assert env.core.scene == D.multibody_consts(
            S.multi_step_scene(2), ik_workspace=not joint_control,
            gripper='robotiq85')
    for nb in range(1, 6):
        sc = D.multibody_consts(S.multi_step_scene(nb),
                                ik_workspace=not joint_control,
                                gripper='robotiq85')
        assert cuda_multibody.scene_key(sc) in held
        assert cuda_multibody.library(sc) == 'multibody_robotiq'


# ---------------------------------------------- operation count, CPU
@pytest.fixture(scope='module')
def count_kernels():
    """tests/kernels_count.cpp built for the host; skips where there is no
    C++ compiler."""
    if not (shutil.which('g++') or shutil.which('c++')):
        pytest.skip('needs a host C++ compiler')
    return kernel_ops.bind(kernel_ops.host_library(
        kernel_ops.SRC, HOST_FLAGS + ['-pthread']))


@pytest.mark.parametrize('task', ['push', 'reach'])
@pytest.mark.parametrize('control', ['ee', 'joint'])
@pytest.mark.parametrize('kind', ['drop', 'contact'])
def test_engine_count_build_runs_the_host_build(host_kernels, count_kernels,
                                                 task, control, kind):
    """The counting build computes exactly what the float build computes,
    so its count is that of the same branches; the count grows with the
    substeps and is zero for none."""
    has_obj = task == 'push'
    sc = D.scene_consts(S.single_step_scene(has_obj),
                        ik_workspace=control == 'ee')
    st, ctl = inputs(has_obj, kind, 32, seed=1)
    st, ctl = torch_state(st), torch_controls(ctl)
    rows, ctl_rows = cuda_engine.pack(st, ctl)
    prm = torch.tensor(cuda_engine.scene_params(sc), dtype=torch.float32)
    out = torch.empty_like(rows)
    assert host_kernels.engine_host(
        *cuda_engine.scene_key(sc), rows.data_ptr(),
        ctl_rows.data_ptr(), prm.data_ptr(), out.data_ptr(), 32, 3,
        sc.solver_iters) == 0
    ops, counted = kernel_ops.engine_ops(count_kernels, sc, st, ctl, 3)
    for f in ARM_FIELDS + BODY_FIELDS + ('ee_contact_force',):
        assert torch.equal(getattr(counted, f),
                           getattr(cuda_engine.unpack(out, st), f)), f
    ops1, _ = kernel_ops.engine_ops(count_kernels, sc, st, ctl, 1)
    assert 0 < ops1 < ops
    assert kernel_ops.engine_ops(count_kernels, sc, st, ctl, 0)[0] == 0


@pytest.mark.parametrize('kind', ['strike', 'sphere'])
def test_engine_count_build_runs_the_host_build_slide(host_kernels,
                                                      count_kernels, kind):
    """The same for the two slide instances: EE control with the pads
    striking the puck, joint control with a sphere on its cap."""
    sc = slide_scene(kind)
    st, ctl = slide_inputs(kind, 32, seed=1)
    st, ctl = torch_state(st), torch_controls(ctl)
    rows, ctl_rows = cuda_engine.pack(st, ctl)
    prm = torch.tensor(cuda_engine.scene_params(sc), dtype=torch.float32)
    out = torch.empty_like(rows)
    assert host_kernels.engine_host(
        *cuda_engine.scene_key(sc), rows.data_ptr(), ctl_rows.data_ptr(),
        prm.data_ptr(), out.data_ptr(), 32, 3, sc.solver_iters) == 0
    ops, counted = kernel_ops.engine_ops(count_kernels, sc, st, ctl, 3)
    for f in D.PhysicsState._fields:
        assert torch.equal(getattr(counted, f),
                           getattr(cuda_engine.unpack(out, st), f)), f
    ops1, _ = kernel_ops.engine_ops(count_kernels, sc, st, ctl, 1)
    assert 0 < ops1 < ops


@pytest.mark.parametrize('nb', [2, 5])
def test_multibody_count_build_runs_the_host_build(host_kernels,
                                                   count_kernels, nb):
    """K3's counting build (the scenes chip_smoke.py counts) computes
    exactly what the float build computes, on the block pile; the count
    grows with the substeps and is zero for none."""
    sc = D.multibody_consts(S.multi_step_scene(nb))
    st, ctl = multi_inputs(nb, 'contact', 16, seed=1)
    _count_build_runs_the_host_build(host_kernels, count_kernels, sc,
                                     torch_state(st), torch_controls(ctl))


def test_multibody_count_build_runs_the_host_build_multi_geom(
        host_kernels, count_kernels):
    """The same for the push-primitive scene of the slot and the cube, on
    the pads pushing the cube into the slot's mouth."""
    sc = D.multibody_consts(S.shape_assemble_scene(('slot', 'cube')))
    st, ctl = primitive_inputs(('slot', 'cube'), 'press', 16, seed=1)
    _count_build_runs_the_host_build(host_kernels, count_kernels, sc,
                                     torch_state(st), torch_controls(ctl))


def test_multibody_count_build_runs_the_host_build_pinned(host_kernels,
                                                          count_kernels):
    """The same for the insertion scene, on the rectangle resting on the
    slot's mouth between the squeezing pads."""
    sc = D.multibody_consts(S.insertion_scene())
    st, ctl = insertion_inputs('load', 16, seed=1)
    _count_build_runs_the_host_build(host_kernels, count_kernels, sc,
                                     torch_state(st), torch_controls(ctl))


def test_multibody_count_build_runs_the_host_build_chest(host_kernels,
                                                         count_kernels):
    """The same for chest_push's scene with 4 blocks, on a block pressed
    against the door while the pads sweep its handle."""
    sc = D.multibody_consts(S.multi_step_scene(4, True, 'front_sliding'))
    st, ctl = chest_inputs('front_sliding', 4, 'door_block', 16, seed=1)
    _count_build_runs_the_host_build(host_kernels, count_kernels, sc,
                                     torch_state(st), torch_controls(ctl))


def test_count_build_runs_the_host_build_robotiq(host_kernels,
                                                count_kernels):
    """The same for the Robotiq-85's instances chip_smoke.py counts: push
    (K2) with the pads closing on the block, block_rearrange with 2 blocks
    (K3) on the squeezed pile."""
    sc = robotiq_scene('push', 'ee')
    st, ctl = robotiq_inputs('grasp', 32, seed=1)
    st, ctl = torch_state(st), torch_controls(ctl)
    rows, ctl_rows = cuda_engine.pack(st, ctl)
    prm = torch.tensor(cuda_engine.scene_params(sc), dtype=torch.float32)
    out = torch.empty_like(rows)
    assert host_kernels.engine_host(
        *cuda_engine.scene_key(sc), rows.data_ptr(), ctl_rows.data_ptr(),
        prm.data_ptr(), out.data_ptr(), 32, 3, sc.solver_iters) == 0
    ops, counted = kernel_ops.engine_ops(count_kernels, sc, st, ctl, 3)
    for f in D.PhysicsState._fields:
        assert torch.equal(getattr(counted, f),
                           getattr(cuda_engine.unpack(out, st), f)), f
    assert ops > 0
    sc = D.multibody_consts(S.multi_step_scene(2), gripper='robotiq85')
    st, ctl = robotiq_inputs('pile', 16, seed=1, nb=2)
    _count_build_runs_the_host_build(host_kernels, count_kernels, sc,
                                     torch_state(st), torch_controls(ctl))


def _count_build_runs_the_host_build(host_kernels, count_kernels, sc, st,
                                     ctl):
    out = _multibody_host(host_kernels, sc, st, ctl, 3)
    ops, counted = kernel_ops.multibody_ops(count_kernels, sc, st, ctl, 3)
    for f in D.PhysicsState._fields:
        assert torch.equal(getattr(counted, f), getattr(out, f)), f
    ops1, _ = kernel_ops.multibody_ops(count_kernels, sc, st, ctl, 1)
    assert 0 < ops1 < ops
    assert kernel_ops.multibody_ops(count_kernels, sc, st, ctl, 0)[0] == 0


@pytest.mark.parametrize('iters', [0, 1, 8])
def test_ik_count_build_runs_the_host_build(host_kernels, count_kernels,
                                            iters):
    """Bit for bit the host build's answer. With no iteration the kernel
    only clamps 7 data angles to known limits: a max and a min each."""
    rng = np.random.default_rng(3)
    tgt = t(workspace_targets(rng, 32))
    q0 = t(np.asarray(KM.KUKA_REST_POSE, np.float32)
           + rng.uniform(-0.2, 0.2, (32, 7)))
    packed = cuda_ik.pack(tgt, q_init=q0)
    out = torch.empty((7, 32))
    assert host_kernels.ik_host(packed.data_ptr(), out.data_ptr(), 32, iters,
                                *CudaIK().tip_offset) == 0
    ops, counted = kernel_ops.ik_ops(count_kernels, tgt, q_init=q0,
                                     num_iters=iters)
    assert torch.equal(counted, out.t())
    if iters == 0:
        assert ops == 32 * 14
    else:
        assert ops > 32 * 14 * iters


def test_count_rules(count_kernels):
    """What counts, on K1 from targets one iteration apart: the second half
    of the iterations skips the null-space solve, so it costs less."""
    rng = np.random.default_rng(4)
    tgt = t(workspace_targets(rng, 16))
    ops = [kernel_ops.ik_ops(count_kernels, tgt, num_iters=k)[0]
           for k in (0, 1, 2)]
    # num_iters=1: one iteration without the pull; 2: one with, one without
    no_pull = ops[1] - ops[0]
    with_pull = ops[2] - ops[1]
    assert 0 < no_pull < with_pull


# ------------------------------------------------------------ the card


@pytest.mark.cuda
@pytest.mark.parametrize('iters', [8, 40])
def test_ik_kernel_matches_plain(cuda, iters):
    rng = np.random.default_rng(2)
    tgt = t(workspace_targets(rng, N), cuda)
    q0 = t(np.asarray(KM.KUKA_REST_POSE, np.float32)
           + rng.uniform(-0.2, 0.2, (N, 7)), cuda)
    w = CudaIK(num_iters=iters)
    out = w.solve(tgt, q_init=q0)
    torch.cuda.synchronize()
    assert w.launches == 1
    ref = ik.solve(tgt, q_init=q0, num_iters=iters)
    np.testing.assert_allclose(n(out), n(ref), atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize('task', ['push', 'reach'])
@pytest.mark.parametrize('control', ['ee', 'joint'])
@pytest.mark.parametrize('kind', ['drop', 'contact'])
@pytest.mark.parametrize('n_sub', [2, 100])
def test_engine_kernel_matches_plain(cuda, task, control, kind, n_sub):
    """Each scene the kernel library holds: reach and push, with the
    arm-sphere lanes of EE control or all of them (joint control)."""
    has_obj = task == 'push'
    sc = D.scene_consts(S.single_step_scene(has_obj),
                        ik_workspace=control == 'ee')
    st, ctl = inputs(has_obj, kind, N, seed=1)
    st, ctl = torch_state(st, cuda), torch_controls(ctl, cuda)
    w = CudaEngine(sc)
    out = w.control_step(st, ctl, n_substeps=n_sub)
    torch.cuda.synchronize()
    assert w.launches == 1
    ref = EP.control_step(sc, st, ctl, n_sub)
    fields = ARM_FIELDS + (BODY_FIELDS if has_obj else ())
    err = env_errors(out, ref, fields)
    tol = 1e-4 if n_sub == 2 else 2e-3
    bound = noise_bound(sc, st, ctl, n_sub, ref,
                        lambda a, b: env_errors(a, b, fields), tol)[0]
    assert (err <= n(bound)).all()


@pytest.mark.cuda
@pytest.mark.parametrize('kind', SLIDE_KINDS)
@pytest.mark.parametrize('n_sub', [2, 100])
def test_engine_kernel_matches_plain_slide(cuda, kind, n_sub):
    """The two slide instances (the cylinder branch) on slide's stress
    states at 4096 envs, each env within its bound as above. In 'strike'
    and 'cap' the pads ram the puck into the table and a free run of 100
    substeps forks on the last bit (tests/k2_fork_witness.py), so there
    the 100 substeps are held one at a time: the kernel's one substep from
    each state of the plain trajectory within 1e-4 of the plain's next, in
    every env and substep, or where a contact test sits on its threshold,
    within the bound of that substep's own 8 noisy plain runs."""
    sc = slide_scene(kind)
    st, ctl = slide_inputs(kind, N, seed=1)
    st, ctl = torch_state(st, cuda), torch_controls(ctl, cuda)
    w = CudaEngine(sc)
    fields = ARM_FIELDS + BODY_FIELDS
    if n_sub == 100 and kind in ('strike', 'cap'):
        states = plain_trajectory(sc, st, ctl, n_sub)

        def stack(xs):
            return type(xs[0])(*(torch.cat(f) for f in zip(*xs)))

        big, ctls, nxt = (stack(states[:-1]), stack([ctl] * n_sub),
                          stack(states[1:]))
        out = w.control_step(big, ctls, n_substeps=1)
        assert w.launches == 1
        err = env_errors(out, nxt, fields)
        beyond = torch.as_tensor(np.nonzero(err > 1e-4)[0], device=cuda)
        if len(beyond):
            def sub(nt):
                return type(nt)(*(x[beyond] for x in nt))

            bound = n(noise_bound(sc, sub(big), sub(ctls), 1, sub(nxt),
                                  lambda a, b: env_errors(a, b, fields),
                                  1e-4)[0])
            at = n(beyond)
            assert (err[at] <= bound).all(), (at // N, at % N, err[at],
                                              bound)
        return
    out = w.control_step(st, ctl, n_substeps=n_sub)
    torch.cuda.synchronize()
    assert w.launches == 1
    ref = EP.control_step(sc, st, ctl, n_sub)
    err = env_errors(out, ref, fields)
    bound = noise_bound(sc, st, ctl, n_sub, ref,
                        lambda a, b: env_errors(a, b, fields),
                        1e-4 if n_sub == 2 else 2e-3)[0]
    assert (err <= n(bound)).all()


@pytest.mark.cuda
@pytest.mark.parametrize('task', ['push', 'reach', 'slide'])
@pytest.mark.parametrize('n_sub,tol', [(2, 1e-4), (100, 2e-3)])
def test_engine_kernel_matches_plain_on_main_path(cuda, task, n_sub, tol):
    """The control step's inputs at step 26 of a seeded push, reach or
    slide drive at 4096 envs: every env within 1e-4 after 2 substeps and
    within 2e-3 after the full 100."""
    env = make_vec_env(num_envs=N, task=task, seed=2)
    state, _ = env.reset()
    g = torch.Generator(device=cuda).manual_seed(2)
    for _ in range(25):
        state, *_ = env.step(state, 2 * torch.rand(
            (N, env.cfg.action_dim), generator=g, device=cuda) - 1)
    state, f_target = env.core.step_decode_pre(state, torch.zeros(
        (N, env.cfg.action_dim), device=cuda))
    zero = state.phys.door_q
    ctl = D.Controls(q_target=env.core.arm_targets(state), f_target=f_target,
                     door_motor_on=zero > 0, door_target=zero)
    w = CudaEngine(env.core.scene)
    out = w.control_step(state.phys, ctl, n_substeps=n_sub)
    ref = EP.control_step(env.core.scene, state.phys, ctl, n_sub)
    fields = ARM_FIELDS + (BODY_FIELDS if task != 'reach' else ())
    assert env_errors(out, ref, fields).max() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ROBOTIQ_KINDS)
@pytest.mark.parametrize('n_sub', [2, 100])
def test_engine_kernel_matches_plain_robotiq(cuda, kind, n_sub):
    """K2's Robotiq-85 instances for push on the Robotiq stress states at
    4096 envs (tests/torch_common.py:robotiq_inputs; 'sphere' under joint
    control), each env within its bound (`noise_bound`), none beyond it."""
    sc = robotiq_scene('push', 'joint' if kind == 'sphere' else 'ee')
    st, ctl = robotiq_inputs(kind, N, seed=1)
    st, ctl = torch_state(st, cuda), torch_controls(ctl, cuda)
    w = CudaEngine(sc)
    out = w.control_step(st, ctl, n_substeps=n_sub)
    torch.cuda.synchronize()
    assert w.launches == 1
    ref = EP.control_step(sc, st, ctl, n_sub)
    fields = ARM_FIELDS + BODY_FIELDS
    err = env_errors(out, ref, fields)
    bound = noise_bound(sc, st, ctl, n_sub, ref,
                        lambda a, b: env_errors(a, b, fields),
                        1e-4 if n_sub == 2 else 2e-3)[0]
    assert (err <= n(bound)).all()


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['grasp', 'pile', 'sphere'])
def test_multibody_kernel_matches_plain_robotiq(cuda, kind):
    """K3's Robotiq-85 instances for 2 blocks at 4096 envs, 2 substeps: the
    pads closing on a block, squeezing the top block of a pile, and a
    wrist sphere on the table (joint control); each env within its bound,
    with K3's allowance (`noise_bound`)."""
    sc = D.multibody_consts(S.multi_step_scene(2),
                            ik_workspace=kind != 'sphere', gripper='robotiq85')
    st, ctl = robotiq_inputs(kind, N, seed=1, nb=2)
    st, ctl = torch_state(st, cuda), torch_controls(ctl, cuda)
    w = CudaMultiBodyEngine(sc)
    out = w.control_step(st, ctl, n_substeps=2)
    torch.cuda.synchronize()
    assert w.launches == 1
    ref = MP.control_step(sc, st, ctl, 2)
    fields = ARM_FIELDS + BODY_FIELDS
    err = env_errors(out, ref, fields)
    bound, _, allowed, cap = noise_bound(
        sc, st, ctl, 2, ref, lambda a, b: env_errors(a, b, fields), 1e-4)
    share = err / n(bound)
    beyond = np.nonzero(share > 1)[0]
    assert len(beyond) <= allowed and share.max() <= cap, (
        beyond[:8], share[beyond[:8]], allowed, cap)


# K3's stress checks: (blocks, state, substeps). Each 100-substep case costs
# about a minute of noisy plain runs on the card; the squeezed pile after
# 100 substeps is checked by chip_smoke.py.
K3_STRESS_CASES = [(nb, kind, 2) for nb in (2, 5)
                   for kind in ('drop', 'contact', 'sphere')] + [
                       (2, 'drop', 100), (5, 'drop', 100), (2, 'sphere', 100)]


@pytest.mark.cuda
@pytest.mark.parametrize('nb,kind,n_sub', K3_STRESS_CASES)
def test_multibody_kernel_matches_plain(cuda, nb, kind, n_sub):
    """K3 on the stress states of block_rearrange's (2 blocks) and
    block_stack's (5) scenes: EE control on the dropped blocks and on the
    squeezed pile, joint control with a wrist or elbow sphere on the
    table. Each env within its bound (`noise_bound`); no more envs beyond
    it, and none further, than a noisy plain run itself lies beyond the
    others' bound."""
    sc = D.multibody_consts(S.multi_step_scene(nb),
                            ik_workspace=kind != 'sphere')
    st, ctl = multi_inputs(nb, kind, N, seed=1)
    st, ctl = torch_state(st, cuda), torch_controls(ctl, cuda)
    w = CudaMultiBodyEngine(sc)
    out = w.control_step(st, ctl, n_substeps=n_sub)
    torch.cuda.synchronize()
    assert w.launches == 1
    ref = MP.control_step(sc, st, ctl, n_sub)
    fields = ARM_FIELDS + BODY_FIELDS
    err = env_errors(out, ref, fields)
    bound, _, allowed, cap = noise_bound(
        sc, st, ctl, n_sub, ref, lambda a, b: env_errors(a, b, fields),
        1e-4 if n_sub == 2 else 2e-3)
    share = err / n(bound)
    beyond = np.nonzero(share > 1)[0]
    assert len(beyond) <= allowed and share.max() <= cap, (
        beyond[:8], share[beyond[:8]], allowed, cap)


# K3's checks on the push-primitive scenes: (objects, state, control,
# substeps). The 80-substep case costs about 50 s of noisy plain runs on the
# card; chip_smoke.py holds the slot's and the cube's main path and the
# 'press' state after 80 substeps too.
PRIMITIVE_CARD_CASES = [case + (2,) for case in PRIMITIVE_CASES[:4]] + [
    (('slot', 'cube'), 'press', 'ee', 80)]


@pytest.mark.cuda
@pytest.mark.parametrize('keys,kind,control,n_sub', PRIMITIVE_CARD_CASES)
def test_multibody_kernel_matches_plain_multi_geom(cuda, keys, kind, control,
                                                   n_sub):
    """K3 on the push-primitive scenes at the primitive's 1024 envs, 2
    substeps and one sub-target's 80: each env within its bound
    (`noise_bound`), with no more envs beyond it, and none further, than a
    noisy plain run itself lies beyond the others' bound."""
    sc = D.multibody_consts(S.shape_assemble_scene(keys),
                            ik_workspace=control == 'ee')
    st, ctl = primitive_inputs(keys, kind, 1024, seed=1)
    st, ctl = torch_state(st, cuda), torch_controls(ctl, cuda)
    w = CudaMultiBodyEngine(sc)
    out = w.control_step(st, ctl, n_substeps=n_sub)
    torch.cuda.synchronize()
    assert w.launches == 1
    ref = MP.control_step(sc, st, ctl, n_sub)
    fields = ARM_FIELDS + BODY_FIELDS
    err = env_errors(out, ref, fields)
    bound, _, allowed, cap = noise_bound(
        sc, st, ctl, n_sub, ref, lambda a, b: env_errors(a, b, fields),
        1e-4 if n_sub == 2 else 2e-3)
    share = err / n(bound)
    beyond = np.nonzero(share > 1)[0]
    assert len(beyond) <= allowed and share.max() <= cap, (
        beyond[:8], share[beyond[:8]], allowed, cap)


# K3's checks on the insertion scene: (state, control, substeps).
# chip_smoke.py holds the main path and the 'load' and 'slot_pressed'
# states after 100 substeps too.
PINNED_CARD_CASES = [('drop', 'ee', 2), ('load', 'ee', 2),
                     ('slot_pressed', 'ee', 2), ('drop', 'joint', 2),
                     ('drop', 'ee', 100)]


@pytest.mark.cuda
@pytest.mark.parametrize('kind,control,n_sub', PINNED_CARD_CASES)
def test_multibody_kernel_matches_plain_pinned(cuda, kind, control, n_sub):
    """K3 on the insertion scene at its 1024 envs: each env within its
    bound (`noise_bound`), with no more envs beyond it, and none further,
    than a noisy plain run itself lies beyond the others' bound; the slot
    stays where it is pinned."""
    sc = D.multibody_consts(S.insertion_scene(), ik_workspace=control == 'ee')
    st, ctl = insertion_inputs(kind, 1024, seed=1)
    st, ctl = torch_state(st, cuda), torch_controls(ctl, cuda)
    w = CudaMultiBodyEngine(sc)
    out = w.control_step(st, ctl, n_substeps=n_sub)
    torch.cuda.synchronize()
    assert w.launches == 1
    assert torch.equal(out.body_pos[:, 1], st.body_pos[:, 1])
    assert torch.equal(out.body_quat[:, 1], st.body_quat[:, 1])
    ref = MP.control_step(sc, st, ctl, n_sub)
    fields = ARM_FIELDS + BODY_FIELDS
    err = env_errors(out, ref, fields)
    bound, _, allowed, cap = noise_bound(
        sc, st, ctl, n_sub, ref, lambda a, b: env_errors(a, b, fields),
        1e-4 if n_sub == 2 else 2e-3)
    share = err / n(bound)
    beyond = np.nonzero(share > 1)[0]
    assert len(beyond) <= allowed and share.max() <= cap, (
        beyond[:8], share[beyond[:8]], allowed, cap)


# K3's checks on the chest scenes, 2 blocks: (door, state, control,
# substeps). chip_smoke.py holds chest_push's main path (4 blocks) and more
# of these states after 100 substeps.
CHEST_CARD_CASES = [(door, kind, 'ee', 2) for door, kind, _ in
                    CHEST_CASES[:10]] + [
                        ('front_sliding', 'handle', 'joint', 2),
                        ('front_sliding', 'door_block', 'ee', 100)]


@pytest.mark.cuda
@pytest.mark.parametrize('door,kind,control,n_sub', CHEST_CARD_CASES)
def test_multibody_kernel_matches_plain_chest(cuda, door, kind, control,
                                              n_sub):
    """K3 on the chest scenes at the chest paths' 1024 envs: each env
    within its bound (`noise_bound`, the door's state among the fields),
    with no more envs beyond it, and none further, than a noisy plain run
    itself lies beyond the others' bound."""
    sc = D.multibody_consts(S.multi_step_scene(2, True, door),
                            ik_workspace=control == 'ee')
    st, ctl = chest_inputs(door, 2, kind, 1024, seed=1)
    st, ctl = torch_state(st, cuda), torch_controls(ctl, cuda)
    w = CudaMultiBodyEngine(sc)
    out = w.control_step(st, ctl, n_substeps=n_sub)
    torch.cuda.synchronize()
    assert w.launches == 1
    ref = MP.control_step(sc, st, ctl, n_sub)
    fields = ARM_FIELDS + BODY_FIELDS + ('door_q', 'door_qd')
    err = env_errors(out, ref, fields)
    bound, _, allowed, cap = noise_bound(
        sc, st, ctl, n_sub, ref, lambda a, b: env_errors(a, b, fields),
        1e-4 if n_sub == 2 else 2e-3)
    share = err / n(bound)
    beyond = np.nonzero(share > 1)[0]
    assert len(beyond) <= allowed and share.max() <= cap, (
        beyond[:8], share[beyond[:8]], allowed, cap)


@pytest.mark.cuda
@pytest.mark.parametrize('n_sub,tol', [(2, 1e-4), (100, 2e-3)])
def test_multibody_kernel_matches_plain_on_main_path(cuda, n_sub, tol):
    """The control step's inputs at step 26 of a seeded block_rearrange
    drive (2 blocks) at 4096 envs: every env within 1e-4 after 2 substeps
    and within 2e-3 after the full 100, but where the fingers push a block
    and the plain version's own noisy runs part by more than that: there
    the env is held to its `noise_bound`, with no env beyond it."""
    env = make_vec_env(num_envs=N, task='block_rearrange', num_block=2,
                       seed=2)
    state, _ = env.reset()
    g = torch.Generator(device=cuda).manual_seed(2)
    for _ in range(25):
        state, *_ = env.step(state, 2 * torch.rand(
            (N, env.cfg.action_dim), generator=g, device=cuda) - 1)
    state, f_target = env.core.step_decode_pre(state, torch.zeros(
        (N, env.cfg.action_dim), device=cuda))
    zero = state.phys.door_q
    ctl = D.Controls(q_target=env.core.arm_targets(state), f_target=f_target,
                     door_motor_on=zero > 0, door_target=zero)
    sc = env.core.scene
    w = CudaMultiBodyEngine(sc)
    out = w.control_step(state.phys, ctl, n_substeps=n_sub)
    ref = MP.control_step(sc, state.phys, ctl, n_sub)
    fields = ARM_FIELDS + BODY_FIELDS
    err = env_errors(out, ref, fields)
    if err.max() > tol:
        # fingers pushing a block: where the plain version's own noisy runs
        # spread beyond the flat bound, hold the env to noise_bound's
        bound = noise_bound(sc, state.phys, ctl, n_sub, ref,
                            lambda a, b: env_errors(a, b, fields), tol)[0]
        assert (err <= n(bound)).all()
    assert env.core.engine.launches == 25


@pytest.mark.cuda
@pytest.mark.parametrize('scene', ['slide', 'blocks'])
def test_plain_run_graph_matches_eager(cuda, scene):
    """On the card `plain_run` and `plain_trajectory` replay a CUDA graph of
    the plain substep: bit for bit the eager control step's answer (K2's on
    slide's 'strike' state, K3's on the 5-block pile), noisy runs too."""
    if scene == 'slide':
        sc, (st, ctl) = slide_scene('strike'), slide_inputs('strike', N)
        control_step = EP.control_step
    else:
        sc = D.multibody_consts(S.multi_step_scene(5), ik_workspace=True)
        st, ctl = multi_inputs(5, 'contact', N // 4)
        control_step = MP.control_step
    st, ctl = torch_state(st, cuda), torch_controls(ctl, cuda)
    ref = control_step(sc, st, ctl, 5)
    out, active = plain_run(sc, st, ctl, 5)
    assert all(torch.equal(a, b) for a, b in zip(out, ref)) and active
    states = plain_trajectory(sc, st, ctl, 5)
    assert len(states) == 6
    assert all(torch.equal(a, b) for a, b in zip(states[-1], ref))
    assert all(torch.equal(a, b) for a, b in zip(states[2], control_step(
        sc, states[1], ctl, 1)))
    a, _ = plain_run(sc, st, ctl, 5, noise_seed=3)
    b, _ = plain_run(sc, st, ctl, 5, noise_seed=3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, ref))


@pytest.mark.cuda
def test_kernel_wrappers_check_operands(cuda):
    """A wrong dtype or shape raises before any launch."""
    w = CudaIK(num_iters=8)
    with pytest.raises(TypeError):
        w.solve(torch.zeros((8, 3), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        w.solve(torch.zeros((8, 3), device=cuda),
                q_init=torch.zeros((8, 6), device=cuda))
    with pytest.raises(ValueError, match='contiguous'):
        w.launch(torch.zeros((21, 8), device=cuda),
                 torch.zeros((8, 7), device=cuda).t())
    assert w.launches == 0
    # K3: a state of another number of blocks, or rows of another height
    m = CudaMultiBodyEngine(D.multibody_consts(S.multi_step_scene(2)))
    st, ctl = multi_inputs(3, 'drop', 8)
    with pytest.raises(ValueError, match='bodies'):
        m.control_step(torch_state(st, cuda), torch_controls(ctl, cuda))
    with pytest.raises(ValueError):
        m.launch(torch.zeros((62, 8), device=cuda),
                 torch.zeros((11, 8), device=cuda),
                 torch.zeros((62, 8), device=cuda), 1)
    assert m.launches == 0
