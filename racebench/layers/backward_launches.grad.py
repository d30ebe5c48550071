"""Device kernels launched inside one `torch.autograd.grad` (the adjoint
layer's backward), from the profiler, over the traced steps."""
from readings import launches


def read(run):
    return launches(run, "backward")
