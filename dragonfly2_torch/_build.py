"""Build the port's CUDA sources into shared libraries at first use.

Each source under ``csrc/`` compiles with ``nvcc`` into one ``.so`` with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds); the sources share the headers ``csrc/*.cuh``. Libraries go
to ``build/torch_kernels/`` at the root of the checkout, named by the hash
of their source and the headers, so an edited source or header rebuilds and
an unchanged one is reused. Nothing is built when a module is imported:
``load`` builds on the first launch; different libraries may be loaded
from several threads at once, and then compile in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"

# library name → source file under csrc/
SOURCES = {
    "flash_fwd_sm90": "flash_fwd_sm90.cu",
    "flash_fwd_tf32x3": "flash_fwd_tf32x3.cu",
    "flash_bwd": "flash_bwd.cu",
    "flash_bwd_sm90": "flash_bwd_sm90.cu",
    "flash_bwd_tf32x3": "flash_bwd_tf32x3.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "-I", str(CSRC_DIR),  # the shared headers, also for sources built elsewhere
)

_locks = {name: threading.Lock() for name in SOURCES}
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default location; raises when none exists."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _paths(name: str) -> tuple[Path, Path]:
    src = CSRC_DIR / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    return src, BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _compile(name: str) -> None:
    """Run ``nvcc`` for ``name`` unless its library is built."""
    src, lib = _paths(name)
    if lib.exists():
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{proc.stdout}")
    # the compiler's report (registers, shared memory, spills) beside the
    # library; the rename makes the library appear whole or not at all
    lib.with_suffix(".log").write_text(proc.stdout)
    os.replace(tmp, lib)


def build_log(name: str) -> str:
    """The compiler's report for the built library ``name``."""
    return _paths(name)[1].with_suffix(".log").read_text()


def library_path(name: str) -> Path:
    """Where library ``name`` is (or will be) built."""
    return _paths(name)[1]


def load(name: str) -> ctypes.CDLL:
    """The ``ctypes`` handle of library ``name``, built if needed."""
    with _locks[name]:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        _compile(name)
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib
