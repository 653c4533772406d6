"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on first use into
``build/repro_torch/<hash>/lib<name>.so`` at the repository root, where
``<hash>`` covers every source and the nvcc flags, so an edited source
builds anew and an unchanged one loads at once. The sources expose a
plain ``extern "C"`` launcher (no PyTorch headers), which keeps a build
to seconds. Nothing is compiled when this module is imported.

A variant built with macros (``load(name, defines=("X",))``, nvcc's
``-DX``) sits beside it as ``lib<name>-<tag>.so``, ``<tag>`` covering the
macros; only that source is compiled for it.

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

_loaded: dict[tuple[str, tuple[str, ...]], ctypes.CDLL] = {}


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


def build_all(defines: tuple[str, ...] = (),
              names: tuple[str, ...] | None = None) -> dict[str, Path]:
    """Compile every missing ``lib<name>.so`` (of the sources in ``names``,
    default all; with ``defines``, their variant), one nvcc per source,
    all started together. Returns name -> library path. The compiler's
    output (register and shared-memory use) lands in ``<name>.log``
    (``<name>-<tag>.log`` for a variant)."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return _build_missing(out_dir, defines, names)


def _build_missing(out_dir: Path, defines: tuple[str, ...],
                   names: tuple[str, ...] | None) -> dict[str, Path]:
    tag = ("-" + hashlib.sha256(" ".join(defines).encode()).hexdigest()[:8]
           if defines else "")
    srcs = [src for src in _sources() if names is None or src.stem in names]
    libs = {src.stem: out_dir / f"lib{src.stem}{tag}.so" for src in srcs}
    flags = [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]
    procs = []
    for src in srcs:
        lib = libs[src.stem]
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".so.tmp{os.getpid()}")
        log_path = out_dir / f"{src.stem}{tag}.log"
        log = open(log_path, "w")
        procs.append((src, lib, tmp, log, log_path, subprocess.Popen(
            [_nvcc(), *flags, "-o", str(tmp), str(src)],
            stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for src, lib, tmp, log, log_path, proc in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, lib)
        else:
            failed.append(f"{src.name} (rc {rc}): "
                          + log_path.read_text()[-4000:])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return libs


def load(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded ``lib<name>.so`` (with ``defines``, that variant), built
    first if needed."""
    key = (name, tuple(defines))
    if key not in _loaded:
        libs = (build_all(key[1], (name,)) if defines else build_all())
        _loaded[key] = ctypes.CDLL(str(libs[name]))
    return _loaded[key]
