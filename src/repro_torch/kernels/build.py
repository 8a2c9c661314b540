"""Build and load the CUDA kernels of ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library, loaded with
``ctypes``.  The build happens at first use (or up front, all sources in
parallel, through :func:`build_all`) into ``repro_torch/_build/``, which
git ignores.  A library's file name carries a hash of its source and
flags and of every local header it includes (``csrc/*.cuh``), so an
edited source or header is rebuilt and a stale library never loads.
Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("grouped_matmul", "flash_attention", "flash_attention_bwd",
           "block_reorder")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_INCLUDE = re.compile(r'\s*#\s*include\s+"([^"]+)"')
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (neither on PATH nor under "
                           "CUDA_HOME); the CUDA kernels cannot be built")
    return str(path)


def _sources(path: Path, seen: list[Path]) -> list[Path]:
    """``path`` and every header of ``csrc`` it includes (``#include
    "..."``), recursively, each once."""
    if path not in seen:
        seen.append(path)
        for line in path.read_text().splitlines():
            m = _INCLUDE.match(line)
            if m:
                _sources(path.parent / m.group(1), seen)
    return seen


def library_path(name: str) -> Path:
    """The library's file: its name carries a hash of the source, every
    header it includes and the flags."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in _sources(CSRC / f"{name}.cu", []):
        h.update(path.name.encode() + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def nvcc_command(name: str, out: Path) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out),
            str(CSRC / f"{name}.cu")]


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.  Returns each compiled
    source's compiler output (``-Xptxas -v``: registers, shared memory,
    spills); raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(nvcc_command(name, Path(tmp)),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, Path(tmp), target)
    logs, failed = {}, []
    for name, (proc, tmp, target) in jobs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, target)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib
