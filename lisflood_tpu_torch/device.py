"""Device resolution and host-to-device conversion of NumPy inputs."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA device; a machine without one raises. Any other
    value is taken as the caller's explicit choice (e.g. "cpu" in tests)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)


def to_device(tree, device, dtype):
    """dict of NumPy arrays / scalars -> dict of tensors on `device`.

    Floating values take `dtype`, booleans stay bool, integers become int64
    (the index type of torch's gather and scatter ops)."""
    out = {}
    for k, v in tree.items():
        a = np.asarray(v)
        if a.dtype.kind == "f":
            out[k] = torch.as_tensor(a, dtype=dtype, device=device)
        elif a.dtype.kind == "b":
            out[k] = torch.as_tensor(a, dtype=torch.bool, device=device)
        elif a.dtype.kind in "iu":
            out[k] = torch.as_tensor(a.astype(np.int64), device=device)
        else:
            raise TypeError(f"{k}: unsupported dtype {a.dtype}")
    return out
