"""Plain reference of the 27-point 3-D Jacobi, written from its formula in
plain PyTorch; it imports nothing of the program under test.

    j27[i, k, j] = sum over di, dk, dj in {-1, 0, 1} of
                   jc[c] * u[i + di, k + dk, j + dj] / jnorm,
    c = (di != 0) + (dk != 0) + (dj != 0),

over the points one in from every face.  Arrays may carry leading batch
axes; each scalar then has those axes too.  Everything runs in the dtype
of the tensors given, and the backward is plain autograd through this.
"""
import torch


def _bcast(s: torch.Tensor, lead: int) -> torch.Tensor:
    return s.reshape(tuple(s.shape) + (1,) * (3 + lead - s.dim()))


def forward(arrays: dict, scalars: dict) -> dict:
    u = arrays["u"]
    lead = u.dim() - 3
    n0, n1, n2 = u.shape[-3:]
    jc = [_bcast(scalars[f"jc{c}"], lead) for c in range(4)]
    acc = None
    for di in (-1, 0, 1):
        for dk in (-1, 0, 1):
            for dj in (-1, 0, 1):
                tap = u[..., 1 + di:n0 - 1 + di, 1 + dk:n1 - 1 + dk,
                        1 + dj:n2 - 1 + dj]
                term = jc[(di != 0) + (dk != 0) + (dj != 0)] * tap
                acc = term if acc is None else acc + term
    return {"j27": acc / _bcast(scalars["jnorm"], lead)}
