"""Build the CUDA kernels of ``csrc/`` at first use and load them.

Each ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. All sources
compile at once, one ``nvcc`` each. The libraries go to
``slate_tpu_torch/_build/<hash>/``, keyed on a hash of the sources and
flags, so a checkout builds everything on its first kernel call and a
changed source never loads a stale library. Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..errors import SlateError

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> loaded library; name -> ptxas report of its last build
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise SlateError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict[str, Path]:
    """Compile every source whose library is missing, all at once;
    returns kernel-source name → library path. Raises
    :class:`SlateError` with the compiler's output if a build fails."""
    out = BUILD_DIR / _digest()
    libs = {src.stem: out / f"lib{src.stem}.so" for src in _sources()}
    if all(p.exists() for p in libs.values()):
        return libs
    nvcc = _nvcc()
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in _sources():
        if libs[src.stem].exists():
            continue
        tmp = out / f".lib{src.stem}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((src.stem, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, libs[name])
    if failed:
        raise SlateError("nvcc failed for " + "\n".join(failed))
    return libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        paths = build()
        if name not in paths:
            raise SlateError(f"no kernel source csrc/{name}.cu")
        lib = ctypes.CDLL(str(paths[name]))
        _LIBS[name] = lib
    return lib
