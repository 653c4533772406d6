"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on first use into
``build/repro_torch/<hash>/lib<name>.so`` at the repository root, where
``<hash>`` covers every source and the nvcc flags, so an edited source
builds anew and an unchanged one loads at once. The sources expose a
plain ``extern "C"`` launcher (no PyTorch headers), which keeps a build
to seconds. Nothing is compiled when this module is imported.

Processes that build at once (the ranks of a collective run) take turns
under an exclusive ``flock`` on ``<hash>/lock``, so one source is compiled
once; the lock dies with its holder, so a cut run leaves none behind.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every missing ``lib<name>.so``, one nvcc per source, all
    started together. Returns name -> library path. The compiler's
    output (register and shared-memory use) lands in ``<name>.log``."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return _build_missing(out_dir)


def _build_missing(out_dir: Path) -> dict[str, Path]:
    libs = {src.stem: out_dir / f"lib{src.stem}.so" for src in _sources()}
    procs = []
    for src in _sources():
        lib = libs[src.stem]
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".so.tmp{os.getpid()}")
        log = open(out_dir / f"{src.stem}.log", "w")
        procs.append((src, lib, tmp, log, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for src, lib, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, lib)
        else:
            failed.append(f"{src.name} (rc {rc}): "
                          + (out_dir / f"{src.stem}.log").read_text()[-4000:])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built first if needed."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build_all()[name]))
    return _loaded[name]
