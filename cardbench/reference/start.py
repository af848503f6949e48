"""The members' initial states, as the reference works them out: the
model's state in the program's floating type and, for an ensemble, each
member's perturbation (LISFLOOD's perturbState, add1.py:918-945):
v (1 + sigma N(0, 1)), clamped at 0, the noise of each field drawn in turn
from a generator seeded with the run's seed on the run's device, over the
members' states laid end to end along the pixel axis."""
from __future__ import annotations

import numpy as np


def members_start(torch, state, traffic, seed, device, dtype):
    """A list of the members' initial natural states (NumPy)."""
    M = int(traffic["members"])
    cast = {k: np.asarray(v).astype(np.float32 if dtype == torch.float32 else np.float64)
            if np.asarray(v).dtype.kind == "f" else np.asarray(v) for k, v in state.items()}
    if M == 1:
        return [cast]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = [dict(cast) for _ in range(M)]
    for field in traffic["perturb"]:
        v = torch.as_tensor(np.concatenate([cast[field]] * M, axis=-1), device=device)
        noise = torch.randn(v.shape, generator=gen, dtype=v.dtype, device=v.device)
        v = torch.clamp_min(v * (1.0 + traffic["sigma"] * noise), 0.0).cpu().numpy()
        parts = v.reshape(v.shape[:-1] + (M, -1))
        for m in range(M):
            out[m][field] = parts[..., m, :]
    return out
