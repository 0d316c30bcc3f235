"""Operation counts of the port's CUDA kernels on given inputs, and host
builds of the kernels' sources.

`tests/kernels_count.cpp` compiles the kernels' per-environment device code
for the host with a float type that counts the arithmetic the data needs
(see its header for what counts). ``build`` compiles it with the host C++
compiler; ``ik_ops``, ``engine_ops`` and ``multibody_ops`` run it on the
inputs a kernel is given and return the count over all environments
together with the counting build's own output (equal to the host float
build's). ``host_library`` builds a host source once for every process
that asks (the test workers share it). Imports no JAX; used by
tests/test_torch_kernels.py and by chip_smoke.py for the kernels' operation
bound.
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from pybullet_multigoal_gym_tpu_torch.ops import (_build, cuda_engine, cuda_ik,
                                                 cuda_multibody)

SRC = Path(__file__).resolve().parent / 'kernels_count.cpp'
COUNT_FLAGS = ['-std=c++17', '-O2', '-ffp-contract=off', '-shared', '-fPIC',
               '-pthread']


def _cxx():
    cxx = shutil.which('g++') or shutil.which('c++')
    if cxx is None:
        raise RuntimeError('needs a host C++ compiler')
    return cxx


def host_library(src, flags):
    """Build ``src`` with the host C++ compiler into the package's build
    directory (`ops/_build.py`'s, ignored by git), keyed by a hash of the
    flags and of every kernel source, under a file lock: the first process
    to ask builds it, the others wait and load the same library. Returns
    its path."""
    src = Path(src)
    h = hashlib.sha256(' '.join(flags).encode())
    for f in [src] + sorted(_build.CSRC.glob('*.cu*')):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    out_dir = _build.BUILD_DIR / 'host'
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / ('lib%s-%s.so' % (src.stem, h.hexdigest()[:16]))
    with open(str(path) + '.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            tmp = path.with_suffix('.tmp%d.so' % os.getpid())
            out = subprocess.run([_cxx()] + flags + ['-o', str(tmp), str(src)],
                                 capture_output=True, text=True, timeout=600)
            if out.returncode != 0:
                raise RuntimeError('%s failed to build:\n%s'
                                   % (src.name, out.stderr))
            os.replace(tmp, path)
    return path


def build(out_dir, start_only=False):
    """Compile kernels_count.cpp into ``out_dir``; returns the loaded
    library, or with ``start_only`` the running compiler (pass it to
    ``load``)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / 'libkernels_count.so'
    proc = subprocess.Popen(
        [_cxx()] + COUNT_FLAGS + ['-o', str(lib), str(SRC)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.lib = lib
    return proc if start_only else load(proc)


def load(proc):
    log, _ = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise RuntimeError('kernels_count.cpp failed to build:\n%s' % log)
    return bind(proc.lib)


def bind(lib):
    """The counting library at path ``lib``, with its C signatures."""
    so = ctypes.CDLL(str(lib))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.ik_count.argtypes = [P, P, I, I, F, F, F, I]
    so.engine_count.argtypes = [I, I, I, I, P, P, P, P, I, I, I, I]
    so.multibody_count.argtypes = [I, I, I, ctypes.c_uint, I,
                                   ctypes.c_ulonglong, I, I, I, ctypes.c_uint,
                                   I, I, P, P, P, P, I, I, I, I, I]
    so.ik_count.restype = so.engine_count.restype = ctypes.c_ulonglong
    so.multibody_count.restype = ctypes.c_ulonglong
    return so


def _threads():
    return max(1, min(8, os.cpu_count() or 1))


def ik_ops(lib, target_pos, target_quat=None, rest_pose=None, q_init=None,
           num_iters=8, gripper='parallel_jaw'):
    """K1's operation count on these inputs toward ``gripper``'s tip (any
    device; counted on the host) and the counting build's (N, 7)
    answer."""
    packed = cuda_ik.pack(target_pos, target_quat, rest_pose, q_init).cpu()
    n = packed.shape[1]
    out = torch.empty((7, n))
    ops = lib.ik_count(packed.data_ptr(), out.data_ptr(), n, int(num_iters),
                       *cuda_ik.CudaIK(gripper=gripper).tip_offset,
                       _threads())
    return int(ops), out.t()


def engine_ops(lib, sc, state, controls, n_substeps):
    """K2's operation count for scene ``sc`` on these inputs (counted on
    the host) and the counting build's state after the step (on the CPU)."""
    rows, ctl_rows = (x.cpu() for x in cuda_engine.pack(state, controls))
    prm = torch.tensor(cuda_engine.scene_params(sc), dtype=torch.float32)
    out = torch.empty_like(rows)
    key = cuda_engine.scene_key(sc)
    ops = lib.engine_count(*key, rows.data_ptr(), ctl_rows.data_ptr(),
                           prm.data_ptr(), out.data_ptr(), rows.shape[1],
                           int(n_substeps), sc.solver_iters, _threads())
    if ops == 2 ** 64 - 1:
        raise ValueError('the kernel library holds no scene %s' % (key,))
    cpu_state = state._replace(**{f: getattr(state, f).cpu()
                                  for f in state._fields})
    return int(ops), cuda_engine.unpack(out, cpu_state)


def multibody_ops(lib, sc, state, controls, n_substeps):
    """K3's operation count for multi-body scene ``sc`` on these inputs
    (counted on the host) and the counting build's state after the step
    (on the CPU)."""
    rows, ctl_rows = (x.cpu() for x in cuda_multibody.pack(state, controls))
    prm = torch.tensor(cuda_multibody.scene_params(sc), dtype=torch.float32)
    out = torch.empty_like(rows)
    key = cuda_multibody.scene_key(sc)
    ops = lib.multibody_count(*key, rows.data_ptr(), ctl_rows.data_ptr(),
                              prm.data_ptr(), out.data_ptr(), prm.numel(),
                              rows.shape[1], int(n_substeps), sc.solver_iters,
                              _threads())
    if ops == 2 ** 64 - 1:
        raise ValueError('the kernel library holds no scene %s' % (key,))
    return int(ops), cuda_multibody.unpack(out, sc.nb)
