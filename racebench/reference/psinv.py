"""Plain reference of NAS MG's smoother psinv, written from its formula in
plain PyTorch; it imports nothing of the program under test.

    u'[i, k, j] = u[i, k, j] + sum over di, dk, dj in {-1, 0, 1} of
                  c[m] * r[i + di, k + dk, j + dj],
    m = (di != 0) + (dk != 0) + (dj != 0),

over the points one in from every face.  Arrays may carry leading batch
axes; each scalar then has those axes too.  Everything runs in the dtype
of the tensors given.
"""
import torch


def _bcast(s: torch.Tensor, lead: int) -> torch.Tensor:
    return s.reshape(tuple(s.shape) + (1,) * (3 + lead - s.dim()))


def forward(arrays: dict, scalars: dict) -> dict:
    u, r = arrays["u"], arrays["r"]
    lead = u.dim() - 3
    n0, n1, n2 = u.shape[-3:]
    c = [_bcast(scalars[f"c{m}"], lead) for m in range(4)]
    acc = u[..., 1:n0 - 1, 1:n1 - 1, 1:n2 - 1]
    for di in (-1, 0, 1):
        for dk in (-1, 0, 1):
            for dj in (-1, 0, 1):
                tap = r[..., 1 + di:n0 - 1 + di, 1 + dk:n1 - 1 + dk,
                        1 + dj:n2 - 1 + dj]
                acc = acc + c[(di != 0) + (dk != 0) + (dj != 0)] * tap
    return {"u": acc}
