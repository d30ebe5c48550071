"""Read a ``torch.profiler`` Chrome trace of the traced window.

The harness marks its own host ranges with ``record_function``:
``racebench.window`` around the whole traced window, and one range around
each part of a call it times (``racebench.forward``, and
``racebench.backward`` in a gradient step).  A device operation belongs to the range in which
the host launched it: its ``correlation`` id leads to the CUDA API call
that launched it, whose start lies inside the range.  The call may be
on another thread than the range: ``torch.autograd.grad`` runs a CUDA
backward on autograd's device thread while the caller waits inside its
range, and the harness launches nothing else meanwhile.  Where the trace has
no such call, its ``External id`` leads to the host operation that was
running.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict

#: device activity: kernels, copies and fills (not the profiler's own
#: ``gpu_user_annotation`` spans)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
PREFIX = "racebench."


def _cat(ev: dict) -> str:
    return str(ev.get("cat", "")).lower()


class Trace:
    """The traced window's device operations, each attributed to the
    harness range that launched it."""

    def __init__(self, events: list):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        self.device = [e for e in xs if _cat(e) in DEVICE_CATS]
        self.host = [e for e in xs if _cat(e) in HOST_CATS]
        launch = {}
        for e in xs:
            if _cat(e) in LAUNCH_CATS and "correlation" in e.get("args", {}):
                launch[e["args"]["correlation"]] = e["ts"]
        by_ext = {}
        for e in self.host:
            ext = e.get("args", {}).get("External id")
            if ext is not None:
                by_ext.setdefault(ext, e["ts"])
        ranges = defaultdict(list)
        for e in self.host:
            if _cat(e) == "user_annotation" and e["name"].startswith(PREFIX):
                ranges[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
        self.ranges = {k: sorted(v) for k, v in ranges.items()}
        self._starts = {k: [r[0] for r in v] for k, v in self.ranges.items()}
        self.launched = []  # each device event's launch time (µs) or None
        for e in self.device:
            args = e.get("args", {})
            at = launch.get(args.get("correlation"))
            if at is None:
                at = by_ext.get(args.get("External id"))
            self.launched.append(at)

    @classmethod
    def from_file(cls, path) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data.get("traceEvents", data) if isinstance(data, dict)
                   else data)

    def window(self):
        """``(start, end)`` in µs of the ``racebench.window`` range, or
        None."""
        w = self.ranges.get(PREFIX + "window")
        return (w[0][0], w[0][1]) if w else None

    def _range_of(self, name: str, ts: float) -> int:
        starts = self._starts.get(name)
        if not starts:
            return -1
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts <= self.ranges[name][i][1]:
            return i
        return -1

    def per_range(self, name: str) -> list:
        """For each range ``racebench.<name>``: ``[device seconds of
        everything launched inside it, kernels launched inside it]``."""
        full = PREFIX + name
        out = [[0.0, 0] for _ in self.ranges.get(full, ())]
        for e, at in zip(self.device, self.launched):
            if at is None:
                continue
            i = self._range_of(full, at)
            if i >= 0:
                out[i][0] += e["dur"] * 1e-6
                out[i][1] += _cat(e) == "kernel"
        return out

    def busy(self) -> list:
        """The union of device activity inside the window, as sorted,
        disjoint ``(start, end)`` µs intervals."""
        win = self.window()
        if win is None:
            return []
        spans = sorted((max(e["ts"], win[0]), min(e["ts"] + e["dur"], win[1]))
                       for e in self.device)
        merged = []
        for lo, hi in spans:
            if hi <= lo:
                continue
            if merged and lo <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        return [tuple(m) for m in merged]

    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in self.busy()) * 1e-6

    def window_s(self) -> float:
        win = self.window()
        return 0.0 if win is None else (win[1] - win[0]) * 1e-6

    def device_ops(self, top: int = 10) -> list:
        """``[name, seconds]`` of the device operations that took most time
        in the window, summed by name."""
        total = defaultdict(float)
        win = self.window()
        for e in self.device:
            if win is None or win[0] <= e["ts"] <= win[1]:
                total[e["name"]] += e["dur"] * 1e-6
        return [[k, v] for k, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """``[what the host was doing, seconds]`` of the longest stretches of
        the window in which the device ran nothing."""
        win = self.window()
        if win is None:
            return []
        edges = [win[0]] + [t for iv in self.busy() for t in iv] + [win[1]]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:top]
        return [[self._host_at(at), dur * 1e-6] for dur, at in gaps]

    def _host_at(self, ts: float) -> str:
        """The harness range and the innermost host operation running at
        ``ts`` (µs)."""
        inner, outer = None, None
        for e in self.host:
            if e["ts"] <= ts < e["ts"] + e["dur"]:
                if e["name"].startswith(PREFIX):
                    if e["name"] != PREFIX + "window":
                        outer = e["name"]
                elif inner is None or e["ts"] >= inner["ts"]:
                    inner = e
        parts = [outer or "between calls"]
        if inner is not None:
            parts.append(inner["name"])
        return " > ".join(parts)
