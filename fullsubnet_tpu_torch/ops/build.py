"""Build the port's CUDA sources into shared libraries.

Each library is compiled by ``nvcc`` from the ``csrc/`` sources of this
package, at first use, into ``_build/`` beside this file (listed in
``.gitignore``). The file name carries a digest of the sources and the
flags, so an edited source is rebuilt and a built one is reused. The
sources expose a plain C interface for ``ctypes``; no PyTorch headers
are compiled. There is no fallback: without ``nvcc`` this raises.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME``, else the
    toolkit's default prefix ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc was not found (PATH, $CUDA_HOME, /usr/local/cuda); the CUDA "
        "kernels of fullsubnet_tpu_torch need the CUDA toolkit to build"
    )


def library_path(name: str, sources: list[Path]) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_library(name: str, sources: list[Path]) -> Path:
    """Compile ``sources`` into ``_build/lib<name>-<digest>.so`` unless it
    exists; returns its path. The compiler's report (registers, shared
    memory, spills from ``-Xptxas -v``) is kept beside it as ``.log``."""
    out = library_path(name, sources)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    log = out.with_suffix(".log")
    log.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {name}:\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: another process never loads a half-written file
    return out
