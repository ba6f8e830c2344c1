"""Build the CUDA sources of ``recnet_tpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface. ``load(name)`` compiles it
with nvcc for ``sm_90a`` into a shared library under
``build/recnet_tpu_torch/`` at the repository root, named by a hash of the
sources and flags (so a changed source rebuilds), and loads it with ctypes.
The build runs at first use. Without nvcc, or when nvcc fails, it raises
with nvcc's output; there is no other route to the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "recnet_tpu_torch"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libraries: Dict[str, ctypes.CDLL] = {}


class BuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise BuildError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "recnet_tpu_torch CUDA kernels build only where the CUDA toolkit "
        "is installed, for an sm_90a (Hopper) card")


def library_path(name: str) -> Path:
    """Where ``name``'s library goes; the hash covers every csrc file."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            digest.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library's path. nvcc's report (registers, spills) goes beside it as
    ``.log``."""
    out = library_path(name)
    if out.is_file():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stderr, file=sys.stderr)
        raise BuildError(f"nvcc failed on {name}.cu (exit "
                         f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/<name>.cu``'s library."""
    if name not in _libraries:
        _libraries[name] = ctypes.CDLL(str(build(name)))
    return _libraries[name]
