"""Build and bind the CUDA kernels: nvcc into a shared library with a plain
C interface, loaded with ctypes.

Every source, whether rendered per plan (the stencil kernel) or kept in
``csrc/`` (``fused_ce.cu``), is written to ``build/repro_torch/<sha256>.cu``
at the root of the checkout and compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -I src/repro_torch/csrc

into ``<sha256>.so`` beside it.  The digest covers the source, every header
of ``csrc/`` it includes (``#include "..."``, followed into nested
includes) and the flags, so a library is reused exactly while they are
unchanged.  :func:`compile_sources` builds many sources at once, one nvcc
process each, all started together; :func:`load` binds the C symbols a
caller names.  Nothing here includes PyTorch's headers, so a build takes
seconds, not minutes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Iterable, Mapping, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: loaded libraries by path (a library is loaded once per process)
_LIBS: dict = {}
_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


class BuildError(RuntimeError):
    """nvcc is missing or refused a source; carries its output."""


def included_headers(source: str) -> list:
    """The ``csrc/`` headers a source includes with ``#include "..."``,
    nested includes too, each once, in the order first met."""
    found: list = []
    todo = _INCLUDE.findall(source)
    while todo:
        name = todo.pop(0)
        path = CSRC / name
        if path in found or not path.is_file():
            continue  # not ours: nvcc's own search path resolves it
        found.append(path)
        todo.extend(_INCLUDE.findall(path.read_text()))
    return found


def _digest(source: str) -> str:
    h = hashlib.sha256(source.encode())
    for path in included_headers(source):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def csrc_source(name: str) -> str:
    """The text of a static source kept in ``csrc/``."""
    return (CSRC / name).read_text()


def library_path(source: str) -> Path:
    return BUILD_DIR / f"{_digest(source)}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(nvcc, os.X_OK):
        raise BuildError("nvcc not found on PATH or under /usr/local/cuda; "
                         "the CUDA toolkit is needed to build the kernels")
    return nvcc


def compile_sources(sources: Iterable[str],
                    jobs: Optional[int] = None) -> list:
    """Compile every source whose library is not built yet; return the
    library path of each source, in order.  Raises :class:`BuildError` with
    nvcc's output when any build fails."""
    sources = list(sources)
    paths = [library_path(s) for s in sources]
    todo = {}
    for src, so in zip(sources, paths):
        if not so.exists():
            todo[so] = src
    if not todo:
        return paths
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = jobs or os.cpu_count() or 1
    pending = list(todo.items())
    running: list = []
    failures: list = []
    try:
        while pending or running:
            while pending and len(running) < jobs:
                so, src = pending.pop()
                # per-process staging names: a concurrent builder of the
                # same source never rewrites a file under this nvcc
                stage = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
                cu, tmp = stage.with_suffix(".cu"), stage.with_suffix(".so")
                cu.write_text(src)
                proc = subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                     str(cu)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                running.append((proc, so, tmp, cu))
            proc, so, tmp, cu = running.pop(0)
            log, _ = proc.communicate()
            if proc.returncode == 0:
                # atomic: concurrent builders agree
                os.replace(cu, so.with_suffix(".cu"))
                os.replace(tmp, so)
            else:
                failures.append(f"{cu}:\n{log}")
    finally:
        for proc, *_ in running:
            proc.kill()
            proc.wait()
    if failures:
        raise BuildError("nvcc failed:\n" + "\n".join(failures))
    return paths


def load(source: str, symbols: Mapping[str, tuple]) -> ctypes.CDLL:
    """The loaded library of one source, built if needed, with each C
    function of ``symbols`` bound: ``{name: (restype, [argtypes])}``.
    Pointers and the stream are ``ctypes.c_void_p``: a bare Python int would
    pass as a 32-bit int and cut them."""
    (path,) = compile_sources([source])
    lib = _LIBS.get(path)
    if lib is None:
        lib = _LIBS[path] = ctypes.CDLL(str(path))
    for name, (restype, argtypes) in symbols.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = list(argtypes)
    return lib
