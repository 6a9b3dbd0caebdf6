"""Builds the port's CUDA sources with ``nvcc`` and loads them with ``ctypes``.

A kernel family's ``*.cu`` files have a plain C interface and include none of
PyTorch's headers, so a build takes seconds.  The library is built at first
use, from the sources in the repository and nothing else, into
``kernels/_build/`` (git-ignored): one ``nvcc -c`` per source, all started
together, then one link.  The directory name carries a hash of the sources
and flags, so an edited source is never served by a stale library.

Nothing here runs when a module is imported: a machine without ``nvcc`` can
import every module of the package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Sequence

BUILD_ROOT = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict = {}


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc was not found (CUDA_HOME, PATH, /usr/local/cuda): the CUDA "
        "kernels of repro_torch are compiled at first use and need the CUDA "
        "toolkit")


def _digest(sources: Sequence[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    dirs = sorted({s.parent for s in sources})
    files = sorted(set(sources) | {p for d in dirs for p in d.glob("*.cuh")})
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _compile(name: str, sources: Sequence[Path], out_dir: Path) -> None:
    nvcc = find_nvcc()
    tmp = out_dir.with_name(out_dir.name + f".tmp{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    try:
        objs, procs = [], []
        for src in sources:
            obj = tmp / (src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        log = []
        failed = False
        for src, proc in zip(sources, procs):
            out, _ = proc.communicate()
            log.append(f"== nvcc {src.name} (rc {proc.returncode})\n{out}")
            failed = failed or proc.returncode != 0
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(log))
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp / f"lib{name}.so"),
             *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
        (tmp / "build.log").write_text("\n".join(log))
        try:
            tmp.rename(out_dir)
        except OSError:
            # another process finished the same build first: use its copy
            if not (out_dir / f"lib{name}.so").exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def build_dir(name: str, sources: Sequence[Path]) -> Path:
    return BUILD_ROOT / f"{name}-{_digest(sources)}"


def load_library(name: str, sources: Sequence[Path]) -> ctypes.CDLL:
    """The shared library ``name`` built from ``sources``; compiled on the
    first call of a process that finds no build of these exact sources."""
    if name in _LOADED:
        return _LOADED[name]
    sources = [Path(s) for s in sources]
    out_dir = build_dir(name, sources)
    lib_path = out_dir / f"lib{name}.so"
    if not lib_path.exists():
        _compile(name, sources, out_dir)
    lib = ctypes.CDLL(str(lib_path))
    _LOADED[name] = lib
    return lib


def load_libraries(specs: Sequence[tuple]) -> list:
    """``load_library(name, sources)`` for each ``(name, sources)`` at once:
    the ``nvcc`` processes of all of them start together."""
    with ThreadPoolExecutor(max(1, len(specs))) as pool:
        return list(pool.map(lambda spec: load_library(*spec), specs))
