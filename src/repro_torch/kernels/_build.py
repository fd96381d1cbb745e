"""Build and load the port's CUDA kernel libraries.

Each kernel family keeps its source under ``<family>/csrc/<family>.cu``
with a plain C interface.  ``build`` compiles a source with ``nvcc`` for
``sm_90a`` into ``build/`` at the repository root, named by a hash of the
source (an edited source is rebuilt, an unchanged one is not), and
``load`` opens the result with ``ctypes``.  ``build_many`` starts one
``nvcc`` per source that needs it, all at once, and waits for them all.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[pathlib.Path, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(source: pathlib.Path) -> pathlib.Path:
    """Where the library of ``source`` lands: ``build/lib<stem>_<hash>.so``."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def build_many(sources: list[pathlib.Path]) -> dict[pathlib.Path, tuple[pathlib.Path, str, float]]:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together.  Returns ``{source: (library, compiler log,
    seconds)}``; the log holds ptxas's register and spill report when a
    build ran and is empty otherwise.  Raises if any build fails."""
    out: dict[pathlib.Path, tuple[pathlib.Path, str, float]] = {}
    running = []
    for src in sources:
        lib = library_path(src)
        if lib.exists():
            out[src] = (lib, "", 0.0)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running.append((src, lib, tmp, proc, time.perf_counter()))
    errors = []
    for src, lib, tmp, proc, t0 in running:
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {src.name} failed ({proc.returncode}):\n{err[-4000:]}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
        out[src] = (lib, err, time.perf_counter() - t0)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def build(source: pathlib.Path) -> tuple[pathlib.Path, str]:
    """Compile ``source`` if its library has not been built yet; returns
    (library path, compiler log)."""
    lib, log, _ = build_many([source])[source]
    return lib, log


def load(source: pathlib.Path) -> ctypes.CDLL:
    """The library of ``source``, built if need be and opened once per
    process."""
    path, _ = build(source)
    lib = _loaded.get(path)
    if lib is None:
        lib = _loaded[path] = ctypes.CDLL(str(path))
    return lib
