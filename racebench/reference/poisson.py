"""Plain reference of the 19-point Poisson relaxation, written from its
formula in plain PyTorch; it imports nothing of the program under test.

    pois[i, k, j] = pc0 * u[i, k, j]
                    - pc1 * (sum of u over the 6 face neighbours)
                    - pc2 * (sum of u over the 12 edge neighbours),

over the points one in from every face.  Arrays may carry leading batch
axes; each scalar then has those axes too.  Everything runs in the dtype
of the tensors given.
"""
import torch


def _bcast(s: torch.Tensor, lead: int) -> torch.Tensor:
    return s.reshape(tuple(s.shape) + (1,) * (3 + lead - s.dim()))


def forward(arrays: dict, scalars: dict) -> dict:
    u = arrays["u"]
    lead = u.dim() - 3
    n0, n1, n2 = u.shape[-3:]
    c = [_bcast(scalars[f"pc{m}"], lead) for m in range(3)]
    ring = {1: None, 2: None}
    for di in (-1, 0, 1):
        for dk in (-1, 0, 1):
            for dj in (-1, 0, 1):
                m = (di != 0) + (dk != 0) + (dj != 0)
                if m in ring:
                    tap = u[..., 1 + di:n0 - 1 + di, 1 + dk:n1 - 1 + dk,
                            1 + dj:n2 - 1 + dj]
                    ring[m] = tap if ring[m] is None else ring[m] + tap
    inner = (..., slice(1, n0 - 1), slice(1, n1 - 1), slice(1, n2 - 1))
    return {"pois": (c[0] * u[inner] - c[1] * ring[1]) - c[2] * ring[2]}
