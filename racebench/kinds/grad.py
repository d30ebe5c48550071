"""Gradient steps: one call is a forward call with every input requiring
grad (range ``racebench.forward``), then ``torch.autograd.grad`` of every
input against a cotangent drawn from the seed (range
``racebench.backward``).  Its answer is the outputs and the gradients,
judged against plain autograd through the plain reference."""
import time

import torch

import verdict

#: the functions of ``work/<program>.py`` whose bounds the metrics read
WORK = ("forward", "backward")


def prepare(program, sets: list, traffic: dict, gen, lead: tuple) -> list:
    """Each input set's tensors as leaves of their own, as a caller's are,
    and ``"cotangent"``: one uniform [-1, 1] array per output."""
    shape = lead + tuple(program.output_shape(traffic["extent"]))
    first = next(iter(sets[0].values()))
    cots = torch.rand((len(sets), len(program.OUTPUTS)) + shape,
                      generator=gen, device=first.device, dtype=first.dtype)
    cots.mul_(2).sub_(1)
    out = []
    for p, env in enumerate(sets):
        env = {k: v.clone().requires_grad_() for k, v in env.items()}
        env["cotangent"] = {nm: cots[p, o]
                            for o, nm in enumerate(program.OUTPUTS)}
        out.append(env)
    return out


def call(run, env: dict, rng):
    """``((outputs, gradients), host seconds inside both calls)``."""
    outputs = run.program.OUTPUTS
    ins = {k: v for k, v in env.items() if k != "cotangent"}
    with rng("racebench.forward"):
        t = time.perf_counter()
        out = run.forward(ins)
        host = time.perf_counter() - t
    with rng("racebench.backward"):
        t = time.perf_counter()
        grads = torch.autograd.grad(
            [out[o] for o in outputs], list(ins.values()),
            [env["cotangent"][o] for o in outputs])
        host += time.perf_counter() - t
    return (out, dict(zip(ins, grads))), host


def reference(ref, program, env: dict, dtype):
    return verdict.reference_gradients(ref, program, env, dtype)


def gaps(answer, want, program) -> dict:
    return {"max_rel_err": verdict.output_gap(answer[0], want[0]),
            "grad_rel_err": verdict.grad_gap(answer[1], want[1],
                                             program.SCALARS)}
