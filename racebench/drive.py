"""The general traffic generator and the measured window of one run.

A traffic mix is a data file (``traffic/<name>.json``) of parameters:

- ``kind``: the generator, ``kinds/<kind>.py``, found by name: what one
  call of the traffic is (``call``), what its inputs hold beyond the
  program's own (``prepare``), what work it does (``WORK``, functions of
  ``work/<program>.py``) and how its answer is judged (``reference``,
  ``gaps``); a kind may bring its own system under test (``build``, in
  place of RACE's build of the program) and its own window (``loop``, in
  place of the closed loop here);
- ``extent``: the arrays' extent, which the program turns into its
  arrays' and outputs' shapes (``array_shape``, ``output_shape``);
- ``dtype``: the arrays' and scalars' dtype;
- ``batch``: examples a call (0: one, no batch axis);
- ``pool``: sets of inputs drawn from the seed, taken in turn, so that no
  call reads what the previous one read;
- ``in_flight``: calls the host may have queued ahead of the card; the
  host waits for call ``i - in_flight`` before it makes call ``i``, so each
  call's host time is its enqueue and never a wait for a full launch
  queue.  0: each call is waited for, as a caller of a service waits, and
  its latency is kept.

Every seed draws the same sizes in the same order; only the values
differ.  Inputs are drawn on the device in a few large calls.  A
configuration's ``scalars`` fix scalars at published values; the others
are drawn.
"""
from __future__ import annotations

import json
import os
import random
import tempfile
import time
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass, field

import torch

import benchspec
import devtrace
import peaks
import verdict

#: answers kept for the comparison: SAMPLES calls drawn from the seed among
#: the first SAMPLE_SPAN, and the window's last call
SAMPLES = 2
SAMPLE_SPAN = 16
WARMUP_ROUNDS = 2

clock = time.perf_counter


def _no_range(name: str):
    return nullcontext()


def draw_inputs(cell: benchspec.Cell, seed: int, device) -> list:
    """``traffic["pool"]`` input sets drawn from ``seed`` on ``device``:
    each a dict of the program's arrays (uniform on [-1, 1]) and scalars
    (uniform on [0.25, 1], or the configuration's fixed value), with what
    the traffic's kind adds (its ``prepare``)."""
    program, traffic, kind = cell.program(), cell.traffic, cell.kind()
    n, batch, pool = traffic["extent"], traffic["batch"], traffic["pool"]
    dt = getattr(torch, traffic["dtype"])
    lead = (batch,) if batch else ()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 64)
    arrays = torch.rand((pool, len(program.ARRAYS)) + lead
                        + tuple(program.array_shape(n)),
                        generator=gen, device=device, dtype=dt)
    arrays.mul_(2).sub_(1)
    scalars = torch.rand((pool, len(program.SCALARS)) + lead, generator=gen,
                         device=device, dtype=dt).mul_(0.75).add_(0.25)
    for s, nm in enumerate(program.SCALARS):
        if nm in cell.config.get("scalars", {}):
            scalars[:, s] = cell.config["scalars"][nm]
    sets = []
    for p in range(pool):
        env = {nm: arrays[p, a] for a, nm in enumerate(program.ARRAYS)}
        env.update({nm: scalars[p, s] for s, nm in enumerate(program.SCALARS)})
        sets.append(env)
    if hasattr(kind, "prepare"):
        sets = kind.prepare(program, sets, traffic, gen, lead)
    return sets


@dataclass
class Window:
    """What one stretch of the window measured."""

    calls: int = 0
    elapsed: float = 0.0  # seconds, from the first call to the card's sync
    host_s: float = 0.0  # host seconds inside the calls (the enqueue)
    latency: list = field(default_factory=list)  # seconds a waited call


class Run:
    """One run of one cell: set-up, the window, the comparison."""

    def __init__(self, cell: benchspec.Cell, seed: int, device="cuda",
                 traced: bool = False, t0: float = None, marks=None):
        self.cell, self.seed, self.traced = cell, seed, traced
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.t0 = clock() if t0 is None else t0
        self.marks = dict(marks or {})
        self.program = cell.program()
        self.kind = cell.kind()
        tr = self.traffic = cell.traffic
        work = cell.work()
        itemsize = peaks.ITEMSIZE[tr["dtype"]]
        b = tr["batch"] or 1
        self.points = work.points(tr["extent"], b)
        self.bound = {}
        for what in self.kind.WORK:
            count = getattr(work, what, None)
            if count is None:
                raise benchspec.SpecError(
                    f"work/{cell.config['program']}.py has no {what}(), "
                    f"which traffic kind {tr['kind']!r} needs")
            self.bound[what] = peaks.bound(*count(tr["extent"], itemsize, b),
                                           tr["dtype"])[0]
        self.want = set(random.Random(seed).sample(range(SAMPLE_SPAN),
                                                   SAMPLES))
        self.kept = {}
        self.last = None
        self.calls = 0
        self.spans = None
        self.trace = None
        self.timed = None

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        """Build the plan, draw the inputs and warm every shape; with
        ``traced``, the port's spans are on for this and only this."""
        t = clock()
        parts = self.setup_parts = dict(self.marks)
        parts["harness"] = t - self.t0 - sum(self.marks.values())

        def part(name):
            nonlocal t
            now = clock()
            parts[name] = now - t
            t = now

        from repro_torch import obs, race

        part("port_import")
        if self.cuda:
            torch.empty(1, device=self.device)
            self._sync()
        part("card")
        if self.traced:
            obs.reset()
            obs.configure(enabled=True)
        if hasattr(self.kind, "build"):
            self.res = self.kind.build(self)
        else:
            self.res = race(self.program.build(self.traffic["extent"]),
                            reassociate=self.cell.config["reassociate"],
                            backend="auto")
        part("race")
        self.inputs = draw_inputs(self.cell, self.seed, self.device)
        self._sync()
        part("inputs")
        for r in range(WARMUP_ROUNDS):
            for env in self.inputs:
                self._step(env)
            self._sync()
            part(f"warmup{r}")
        if self.traced:
            self.spans = obs.span_records()
            obs.configure(enabled=False)
            with self._profiler():
                self._step(self.inputs[0])
                self._sync()
            part("profiler")
        self.setup_s = clock() - self.t0

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def _profiler(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)

    # -- one call of the traffic ----------------------------------------
    def forward(self, env: dict) -> dict:
        """The program's outputs for ``env``: ``RaceResult.run``, or
        ``run_batch`` where the traffic has a batch axis."""
        if self.traffic["batch"]:
            return self.res.run_batch(env, device=self.device)
        return self.res.run(env, device=self.device)

    def _step(self, env: dict, rng=_no_range):
        """Issue one call; returns ``(answer, host seconds inside it)``."""
        return self.kind.call(self, env, rng)

    def _loop(self, seconds: float, rng) -> Window:
        if hasattr(self.kind, "loop"):
            return self.kind.loop(self, seconds, rng)
        w = Window()
        ahead = self.traffic["in_flight"]
        pending = deque()
        start = clock()
        deadline = start + seconds
        while clock() < deadline:
            i = self.calls
            p = i % len(self.inputs)
            if not ahead:
                t = clock()
                answer, host = self._step(self.inputs[p], rng)
                self._sync()
                w.latency.append(clock() - t)
            else:
                if len(pending) >= ahead:
                    pending.popleft().synchronize()
                answer, host = self._step(self.inputs[p], rng)
                if self.cuda:
                    ev = torch.cuda.Event()
                    ev.record()
                    pending.append(ev)
            w.host_s += host
            w.calls += 1
            self.calls += 1
            if i in self.want:
                self.kept[i] = (p, answer)
            self.last = (i, p, answer)
            del answer
        self._sync()
        w.elapsed = clock() - start
        return w

    # -- the window -----------------------------------------------------
    def window(self, seconds: float) -> None:
        """Untraced: one window of ``seconds``.  Traced: its first half
        untraced (the host's times), its second under the profiler."""
        if not self.traced:
            self.timed = self._loop(seconds, _no_range)
            return
        self.timed = self._loop(seconds / 2, _no_range)
        with tempfile.TemporaryDirectory(prefix="racebench-") as tmp:
            path = os.path.join(tmp, "trace.json")
            with self._profiler() as prof:
                with torch.profiler.record_function("racebench.window"):
                    self._loop(seconds / 2, torch.profiler.record_function)
            prof.export_chrome_trace(path)
            del prof
            self.trace = devtrace.Trace.from_file(path)

    # -- after the window -----------------------------------------------
    def answers(self) -> list:
        """``(pool index, answer)`` of the sampled calls and the last."""
        kept = dict(self.kept)
        if self.last is not None:
            kept.setdefault(self.last[0], self.last[1:])
        return [kept[i] for i in sorted(kept)]

    def memory_peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.cuda else 0

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        from repro_torch.core.executor import clear_cache

        self.res = None
        clear_cache()
        if self.cuda:
            torch.cuda.empty_cache()

    def judge(self) -> tuple:
        """``({number: (value, limit)}, answers over a limit)`` of the
        comparison with the plain reference (see :mod:`verdict`)."""
        return verdict.judge(self.cell, self.program, self.kind,
                             self.inputs, self.answers())


def measure(cell: benchspec.Cell, seed: int, seconds: float, traced: bool,
            device="cuda", t0: float = None, marks=None, log=None) -> dict:
    """One run of ``cell``: the result's line as a dict, with the numbers
    compared last under ``checks``.  ``marks`` are set-up's parts before
    the harness took over (seconds by name); ``log`` gets a line of
    set-up's parts, its own with them."""
    run = Run(cell, seed, device, traced, t0, marks)
    run.setup()
    if log is not None:
        log("setup parts " + json.dumps(run.setup_parts))
    run.window(seconds)
    peak = run.memory_peak()
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = benchspec.module("layers" if traced else "end_to_end",
                                 m["name"]).read(run)
        if value is None:
            raise benchspec.SpecError(
                f"{m['name']} is listed for {cell.name} in BENCHMARK.json, "
                f"but this run holds nothing for it to read")
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if run.cuda else run.device.type,
           "kind": (torch.cuda.get_device_name(run.device) if run.cuda
                    else "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    line = {"correct": False, "attempted": run.calls, "failed": 0,
            "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s()
        line["breakdown"] = {"device_ops": run.trace.device_ops(),
                             "idle_gaps": run.trace.idle_gaps()}
        run.trace = None
    run.release()
    checks, line["failed"] = run.judge()
    line["correct"] = bool(checks) and all(v <= lim
                                           for v, lim in checks.values())
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    return line
