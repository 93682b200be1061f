"""Build and load the port's CUDA kernels.

Each source under ``src/repro_torch/csrc`` has a plain C interface.  It
is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library
under the repository's ``build/`` directory at first use, named by a hash
of the source, the shared headers (``csrc/*.cuh``) and the flags (so an
edited source or header rebuilds), and loaded
with ``ctypes``.  A missing ``nvcc`` or a failed build raises: nothing
falls back to the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then
    ``/usr/local/cuda/bin/nvcc``, then ``nvcc`` on the PATH."""
    candidates = [Path(os.environ[v]) / "bin" / "nvcc"
                  for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source at first use and need the CUDA toolkit")
    return found


def library_path(source: str) -> Path:
    """Where ``csrc/<source>``'s library goes: named by a hash of the
    source, every shared header ``csrc/*.cuh`` and the flags."""
    src = CSRC_DIR / source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build(source: str) -> tuple[Path, str]:
    """Compile ``csrc/<source>`` unless its library is current; returns
    (library path, compiler log — the ptxas register/shared-memory
    report of a fresh build, read back from the log file otherwise)."""
    src = CSRC_DIR / source
    lib = library_path(source)
    log = lib.with_suffix(".log")
    if lib.is_file():
        return lib, log.read_text() if log.is_file() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source} (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    text = proc.stdout + proc.stderr
    log.write_text(text)
    os.replace(tmp, lib)     # atomic: a concurrent loader sees all or none
    return lib, text


@functools.lru_cache(maxsize=None)
def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``, once per process."""
    lib, _ = build(source)
    return ctypes.CDLL(str(lib))
