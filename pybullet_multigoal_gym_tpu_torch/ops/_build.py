"""Build and load the port's CUDA kernels (`csrc/*.cu`).

Each kernel source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, loaded with ``ctypes``. Nothing is
built when a module is imported: the first launch builds the library it needs
into ``_build/`` beside the package (listed in ``.gitignore``), keyed by a
hash of the sources and flags so an edited source is rebuilt. ``build_all``
starts one ``nvcc`` per source at once.

No ``--use_fast_math``: parity with the plain PyTorch versions depends on
IEEE ``sinf``, ``cosf``, ``sqrtf`` and division. No FMA contraction either
(``--fmad=false``): a fused multiply-add rounds once where the plain version
rounds twice, and in contact-rich states that last-bit difference flips
contact-activation tests (``pen > -1e-4``, the SAT axis choice) in some
environments, which then part by far more than rounding.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent.parent / '_build'
FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
         '--fmad=false', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the libraries' launch functions (all return
# cudaGetLastError() as an int); K3's libraries share one
_MULTIBODY_ARGS = [_I, _I, _I, ctypes.c_uint, _I, ctypes.c_ulonglong, _I, _I,
                   _I, ctypes.c_uint, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P]
SIGNATURES = {
    'ik': ('ik_launch', [_P, _P, _I, _I, _F, _F, _F, _P]),
    'engine': ('engine_launch',
               [_I, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P]),
    'multibody': ('multibody_launch', _MULTIBODY_ARGS),
    'multibody_robotiq': ('multibody_robotiq_launch', _MULTIBODY_ARGS),
    'chest_push': ('chest_push_launch', _MULTIBODY_ARGS),
    'chest_pick': ('chest_pick_launch', _MULTIBODY_ARGS),
}

_LOADED = {}    # name -> Kernel, one load per process


class Kernel:
    """A loaded kernel library: its launch function and what ptxas
    reported for each entry point (registers, stack, spill bytes)."""

    def __init__(self, name, path, fn, ptxas):
        self.name = name
        self.path = path
        self.fn = fn
        self.ptxas = ptxas


def nvcc_path():
    found = shutil.which('nvcc')
    if found:
        return found
    cand = Path(os.environ.get('CUDA_HOME', '/usr/local/cuda')) / 'bin' / 'nvcc'
    if cand.exists():
        return str(cand)
    raise RuntimeError('nvcc not found: the CUDA kernels build only on a '
                       'machine with the CUDA toolkit')


def _sources(name):
    return [CSRC / (name + '.cu')] + sorted(CSRC.glob('*.cuh'))


def _lib_path(name):
    h = hashlib.sha256(' '.join(FLAGS).encode())
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / ('lib%s-%s.so' % (name, h.hexdigest()[:16]))


def parse_ptxas(log):
    """Per entry function: registers, stack frame and spill bytes from the
    ``-Xptxas -v`` report."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {'function': m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                      r'(\d+) bytes spill loads', line)
        if m:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        m = re.search(r'Used (\d+) registers', line)
        if m:
            cur['registers'] = int(m.group(1))
    return out


def _start(name):
    """Start nvcc for ``name`` unless its library is built; returns the
    process (or None) and the library path."""
    path = _lib_path(name)
    if path.exists():
        return None, path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix('.tmp%d.so' % os.getpid())
    cmd = [nvcc_path()] + FLAGS + ['-o', str(tmp), str(CSRC / (name + '.cu'))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.tmp = tmp
    return proc, path


def _finish(name, proc, path):
    if proc is not None:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError('nvcc failed for %s.cu:\n%s' % (name, log))
        path.with_suffix('.log').write_text(log)
        os.replace(proc.tmp, path)
    log_path = path.with_suffix('.log')
    log = log_path.read_text() if log_path.exists() else ''
    lib = ctypes.CDLL(str(path))
    sym, argtypes = SIGNATURES[name]
    fn = getattr(lib, sym)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    k = Kernel(name, path, fn, parse_ptxas(log))
    _LOADED[name] = k
    return k


def build_all(names=tuple(SIGNATURES)):
    """Build (all nvcc processes at once) and load the named kernels."""
    todo = [n for n in names if n not in _LOADED]
    started = [(n,) + _start(n) for n in todo]
    for n, proc, path in started:
        _finish(n, proc, path)
    return {n: _LOADED[n] for n in names}


def load(name):
    """The loaded kernel ``name``, built first if needed."""
    k = _LOADED.get(name)
    return k if k is not None else build_all((name,))[name]


def check(rc, name):
    if rc != 0:
        raise RuntimeError('%s kernel launch failed: CUDA error %d' % (name, rc))
