"""Build the paged attention kernels with ``nvcc`` into a shared library.

The CUDA source has a plain C interface (no PyTorch headers), so ``nvcc``
builds it in seconds; ``ops.py`` loads the library with ``ctypes``.  The
library lands in ``build/repro_torch/`` at the root of the checkout, on
first use, and is rebuilt whenever the source or the flags change (a
digest of both is kept beside it).
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
LIBRARY = BUILD_DIR / "libpaged_attention.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float          # 0.0 when an up-to-date library was reused
    log: str                # nvcc's output (ptxas register/smem report)


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the paged attention kernels are "
                       "built from csrc/ on a machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def build(force: bool = False) -> BuildResult:
    """Compile ``csrc/paged_attention.cu`` for sm_90a (if needed)."""
    stamp = LIBRARY.with_name(LIBRARY.name + ".sha256")
    digest = _digest()
    if (not force and LIBRARY.exists() and stamp.exists()
            and stamp.read_text() == digest):
        return BuildResult(LIBRARY, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIBRARY)
    stamp.write_text(digest)
    return BuildResult(LIBRARY, seconds, proc.stdout + proc.stderr)
