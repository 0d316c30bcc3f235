"""Small tensor helpers shared by the port's modules."""

import numpy as np
import torch

_CONSTS = {}


def const(x, like):
    """A model constant (numpy array or float) as a tensor on ``like``'s
    device and dtype. Cached per value and device so the step path makes no
    host-to-device copy after its first call."""
    a = np.asarray(x, np.float64)
    key = (a.tobytes(), a.shape, like.device, like.dtype)
    t = _CONSTS.get(key)
    if t is None:
        t = torch.as_tensor(a, dtype=like.dtype, device=like.device)
        _CONSTS[key] = t
    return t


_INDEX = {}


def index(idx, like):
    """Integer indices as a long tensor on ``like``'s device, cached per
    value and device as `const` is: indexing with a Python list copies the
    list to the device on every call."""
    key = (tuple(int(i) for i in idx), like.device)
    t = _INDEX.get(key)
    if t is None:
        t = _INDEX[key] = torch.as_tensor(key[0], dtype=torch.long,
                                          device=like.device)
    return t


def resolve_device(device):
    """``None`` means CUDA; CUDA must then be present. The CPU runs only when
    the caller asks for it."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('CUDA is not available; pass device="cpu" to run '
                           'the plain PyTorch path on the CPU')
    return device
