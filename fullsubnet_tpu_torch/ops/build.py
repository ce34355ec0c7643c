"""Build the port's CUDA sources into shared libraries.

Each library is compiled by ``nvcc`` from the ``csrc/`` sources of this
package, at first use, into ``_build/`` beside this file (listed in
``.gitignore``). The file name carries a digest of the sources, the
headers they include and the flags, so an edited file is rebuilt and a
built one is reused. Every ``.cu`` of a library compiles in its own
``nvcc`` process, all started together, and the objects are then linked.
The sources expose a plain C interface for ``ctypes``; no PyTorch headers
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

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    """Where the library of ``sources`` (``.cu`` files and the headers
    they include) is built."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_library(name: str, sources: list[Path]) -> Path:
    """Compile the ``.cu`` files among ``sources`` into
    ``_build/lib<name>-<digest>.so`` unless it exists; returns its path.
    The compiler's report (registers, shared memory, spills from
    ``-Xptxas -v``) is kept beside it as ``.log``."""
    out = library_path(name, sources)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    units = [src for src in sources if src.suffix == ".cu"]
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in units]
    compiles = [
        [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        for src, obj in zip(units, objects)
    ]
    tmp = out.with_name(f"{tag}.so.tmp")
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]
    report = []
    failed = None
    try:
        procs = [
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for cmd in compiles
        ]
        for cmd, proc in zip(compiles, procs):
            stdout, stderr = proc.communicate()
            report.append(" ".join(cmd) + "\n" + stdout + stderr)
            if proc.returncode != 0 and failed is None:
                failed = (cmd, proc.returncode, stderr)
        if failed is None:
            proc = subprocess.run(link, capture_output=True, text=True, check=False)
            report.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed = (link, proc.returncode, proc.stderr)
        out.with_suffix(".log").write_text("\n".join(report))
        if failed is not None:
            cmd, code, err = failed
            raise RuntimeError(f"nvcc failed ({code}) building {name}: {' '.join(cmd)}\n{err}")
        os.replace(tmp, out)  # atomic: another process never loads a half-written file
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objects:
            obj.unlink(missing_ok=True)
    return out
