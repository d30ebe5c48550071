"""Host microseconds inside one step (its forward call and its
`torch.autograd.grad`, through the entry point, the executor and the
adjoint layer) in a cell that reports `grad_gpts`, over the untraced half
of the traced run."""
from readings import host_us


def read(run):
    return host_us(run)
