"""The metrics' C++ core (``fastmetrics.cpp``), built with g++ at first use.

The port's counterpart of ``recnet_tpu/native``: ``fastmetrics`` is the
loaded extension module (``lcs``, ``bleu_stats``, ``cider_stats``) or None,
and ``HAVE_FASTMETRICS`` says which. The first read of either compiles the
source against this interpreter's ``Python.h`` into the build directory the
CUDA kernels use (``ops/cuda/build.py`` ``build_dir()``), under a name
hashed from the source, the flags and the interpreter, and loads it as an
extension module. Where g++ or ``Python.h`` is missing, or the compiler
refuses the source, the scorers keep their pure-Python paths, as the JAX
package's do without its extension; ``BUILD_ERROR`` then holds the reason.

The source stays on the CPython API: its speed comes from walking the
Python lists of token ids directly.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path
from types import ModuleType
from typing import Optional

SOURCE = Path(__file__).resolve().with_name("fastmetrics.cpp")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
MODULE = "recnet_tpu_torch.native._fastmetrics"

_lock = threading.Lock()
_loaded = False
_module: Optional[ModuleType] = None
_error: Optional[str] = None


def library_path() -> Path:
    """Where the built module goes: named by a hash of the source, the
    flags, the include directory and the interpreter's extension suffix."""
    from recnet_tpu_torch.ops.cuda.build import build_dir
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    digest = hashlib.sha256(" ".join(
        CXX_FLAGS + (sysconfig.get_paths()["include"], suffix)).encode())
    digest.update(SOURCE.read_bytes())
    return build_dir() / f"fastmetrics-{digest.hexdigest()[:16]}{suffix}"


def build() -> Path:
    """Compile ``fastmetrics.cpp`` unless its module exists; returns its
    path. Raises RuntimeError with the reason when it cannot."""
    out = library_path()
    if out.is_file():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH")
    include = sysconfig.get_paths()["include"]
    if not (Path(include) / "Python.h").is_file():
        raise RuntimeError(f"Python.h not found in {include}")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, f"-I{include}", "-o", str(tmp),
                           str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SOURCE.name} (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)            # atomic: concurrent builds agree
    return out


def load() -> Optional[ModuleType]:
    """The extension module, built and loaded at the first call; None (and
    ``BUILD_ERROR`` set) when it cannot be built or loaded."""
    global _loaded, _module, _error
    with _lock:
        if not _loaded:
            _loaded = True
            try:
                path = build()
                loader = importlib.machinery.ExtensionFileLoader(MODULE,
                                                                 str(path))
                spec = importlib.util.spec_from_file_location(
                    MODULE, path, loader=loader)
                module = importlib.util.module_from_spec(spec)
                loader.exec_module(module)
                _module = module
            except (RuntimeError, OSError, ImportError) as e:
                _error = f"{type(e).__name__}: {e}"
    return _module


def has(name: str) -> bool:
    """Whether the loaded core has ``name``: a module built from an older
    source may lack a function, and its scorer then stays on Python."""
    this = sys.modules[__name__]     # reads through __getattr__ below
    return bool(this.HAVE_FASTMETRICS) and hasattr(this.fastmetrics, name)


def __getattr__(name: str):
    # the module's attributes are resolved, and the core built, at first
    # read; an assignment (a test switching the core off) then shadows them
    if name == "fastmetrics":
        return load()
    if name == "HAVE_FASTMETRICS":
        return load() is not None
    if name == "BUILD_ERROR":
        load()
        return _error
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
