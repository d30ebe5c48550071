"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; the configuration's files
are ``configs/<config>.json`` (what is run), ``programs/<program>.py`` (the
loop nest and its arrays' shapes), ``reference/<program>.py`` (the plain
reference) and ``work/<program>.py`` (the frozen counts); the traffic mix is
``traffic/<traffic>.json``, whose ``kind`` names the generator
``kinds/<kind>.py`` that reads it; the correctness limits of a cell and its
control's dtype are ``limits/<cell>.json``; each metric's reader is
``end_to_end/<metric>.py`` or ``layers/<metric>.py``.  Nothing here knows a
cell, a configuration, a traffic kind or a metric by name.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")


class SpecError(ValueError):
    """A name ``BENCHMARK.json`` does not hold, or a file it names is
    missing."""


def load(path: Path = ROOT / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def module(kind: str, name: str):
    """The Python file ``<kind>/<name>.py`` of the benchmark, loaded under a
    name of its own (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"no {kind} file for {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"racebench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def data(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise SpecError(f"no {kind} file for {name!r}: {path} is missing")
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str, bench: dict) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads`` key
    lists, or, without the key, every cell (an end-to-end metric) or every
    cell that reports the end-to-end metric it ``moves`` (a per-layer
    one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" not in metric:
        return True
    target = next(m for m in bench["end_to_end"] if m["name"] == metric["moves"])
    return reports(target, cell, bench)


@dataclass
class Cell:
    """One entry of ``workloads`` with everything it names."""

    name: str
    entry: dict
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    limits: dict  # limits/<cell>.json "limits": number compared -> limit
    control_dtype: str  # limits/<cell>.json "control_dtype"
    end_to_end: list  # metric entries this cell reports untraced
    per_layer: list  # metric entries this cell reports traced

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def program(self):
        return module("programs", self.config["program"])

    def reference(self):
        return module("reference", self.config["program"])

    def work(self):
        return module("work", self.config["program"])

    def kind(self):
        """The generator ``kinds/<kind>.py`` of this cell's traffic."""
        return module("kinds", self.traffic["kind"])


def cell(bench: dict, name: str) -> Cell:
    """The cell ``name``; :class:`SpecError` when ``BENCHMARK.json`` has no
    such cell or a file it needs is missing."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        known = ", ".join(w["name"] for w in bench["workloads"])
        raise SpecError(f"no workload {name!r} in BENCHMARK.json ({known})")
    conf = next((c for c in bench["configs"] if c["name"] == entry["config"]),
                None)
    if conf is None:
        raise SpecError(f"workload {name!r} names config {entry['config']!r},"
                        f" which BENCHMARK.json does not hold")
    path = ROOT / conf["file"]
    if not path.is_file():
        raise SpecError(f"config {conf['name']!r}: {path} is missing")
    with open(path) as f:
        config = json.load(f)
    limits = data("limits", name)
    return Cell(
        name=name, entry=entry, config=config,
        traffic=data("traffic", entry["traffic"]),
        limits=limits["limits"], control_dtype=limits["control_dtype"],
        end_to_end=[m for m in bench["end_to_end"]
                    if reports(m, name, bench)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name, bench)])


def problems(bench: dict) -> list:
    """What in ``bench`` breaks the rules a name, a unit or a metric's
    cells must keep (empty when none)."""
    out = []
    cells = [w["name"] for w in bench["workloads"]]
    names = (cells + [c["name"] for c in bench["configs"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
             + [w["config"] for w in bench["workloads"]]
             + [w["traffic"] for w in bench["workloads"]]
             + [k for c in bench["configs"] for k in c["reduced"]])
    out += [f"bad name {n!r}" for n in names if not NAME.match(n)]
    metrics = bench["end_to_end"] + bench["per_layer"]
    out += [f"bad unit {m['unit']!r} of {m['name']}" for m in metrics
            if not UNIT.match(m["unit"])]
    for kind, items in (("cell", cells), ("config", [c["name"] for c in
                                                     bench["configs"]]),
                        ("metric", [m["name"] for m in metrics])):
        dup = {n for n in items if items.count(n) > 1}
        out += [f"{kind} {n!r} named twice" for n in sorted(dup)]
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        if m["moves"] not in e2e:
            out.append(f"{m['name']} moves {m['moves']!r}, no end-to-end "
                       f"metric")
            continue
        target = next(t for t in bench["end_to_end"]
                      if t["name"] == m["moves"])
        for c in cells:
            if reports(m, c, bench) and not reports(target, c, bench):
                out.append(f"{m['name']} in {c}, which does not report "
                           f"{m['moves']}")
    for m in metrics:
        out += [f"{m['name']} lists unknown cell {c!r}"
                for c in m.get("workloads", ()) if c not in cells]
    for c in cells:
        if not any(reports(m, c, bench) for m in bench["per_layer"]):
            out.append(f"{c} reports no per-layer metric")
        if len([m for m in bench["end_to_end"] if reports(m, c, bench)]) < 2:
            out.append(f"{c} reports no end-to-end metric beside setup_s")
    return out
