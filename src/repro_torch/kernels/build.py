"""Build the port's CUDA kernels with ``nvcc`` into shared libraries.

Every CUDA source of the port has a plain C interface (no PyTorch
headers), so ``nvcc`` builds each in seconds; the package's ``ops.py``
loads its library with ``ctypes``.  Libraries land in
``build/repro_torch/`` at the root of the checkout, on first use, and are
rebuilt whenever the source or the flags change (a digest of both is
kept beside each library).  Builds of different sources may run at the
same time (``chip_smoke.py`` starts them together).
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


#: per library: ``nvcc`` runs, and loads into this process (each
#: ``ops.load_library`` notes its one load), read by the audit's
#: rebuild check (``repro_torch.analysis.hygiene.audit_retrace``)
NVCC_RUNS: Dict[str, int] = {}
LOADS: Dict[str, int] = {}


def note_load(name: str) -> None:
    LOADS[name] = LOADS.get(name, 0) + 1


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
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "their csrc/ on a machine with the CUDA toolkit")


def _digest(source: Path) -> str:
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def build(source: Path, name: str, force: bool = False) -> BuildResult:
    """Compile ``source`` for sm_90a into ``lib<name>.so`` (if needed)."""
    source = Path(source)
    library = BUILD_DIR / f"lib{name}.so"
    stamp = library.with_name(library.name + ".sha256")
    digest = _digest(source)
    if (not force and library.exists() and stamp.exists()
            and stamp.read_text() == digest):
        return BuildResult(library, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = library.with_name(f"{library.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    NVCC_RUNS[name] = NVCC_RUNS.get(name, 0) + 1
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, library)
    stamp.write_text(digest)
    return BuildResult(library, seconds, proc.stdout + proc.stderr)
