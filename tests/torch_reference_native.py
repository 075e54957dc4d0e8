"""The JAX package's native decoder, loaded whole for the port's tests.

The reference builds ``native/build/libdfnative.so`` with ``make`` in place
and loads it: under ``pytest -n`` a worker can load the file while another
worker's linker is still writing it, fail, and the reference's ``load()``
then stays failed for that worker's whole life (``_load_failed``), so every
later stream through ``dragonfly2_tpu.schema.native`` raises there.

``load_reference_native()`` builds the reference's own source with its
Makefile's flags into ``build/torch_native/`` under a file lock — beside
it, then renamed, so no process sees a partial library — and installs it
as the reference module's library. The port's tests that hold the port's
decoder against the reference's call it before they first use the
reference's.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from pathlib import Path

from dragonfly2_torch.schema import native as t_native
from dragonfly2_tpu.schema import native as j_native

REPO = Path(__file__).resolve().parent.parent
SOURCE = REPO / "native" / "dfnative.cc"
# native/Makefile's CXXFLAGS and link flag
FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-march=native", "-shared")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    digest.update(t_native._cpu_key())
    return t_native.BUILD_DIR / f"reference-libdfnative-{digest.hexdigest()[:16]}.so"


def load_reference_native() -> ctypes.CDLL:
    """The reference module's library, built once across processes."""
    if j_native._lib is not None:
        return j_native._lib
    path = library_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            subprocess.run(
                [os.environ.get("CXX", "g++"), *FLAGS, "-o", str(tmp), str(SOURCE)],
                check=True, capture_output=True, timeout=300,
            )
            os.replace(tmp, path)
    with j_native._lock:
        j_native._lib = j_native._bind(ctypes.CDLL(str(path)))
        j_native._load_failed = False
    return j_native._lib
