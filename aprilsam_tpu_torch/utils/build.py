"""Build-on-first-use of the port's shared libraries.

Each library is compiled from one source file in the checkout into
``aprilsam_tpu_torch/build/`` (listed in .gitignore), under a name that
carries a hash of the source and the command, so an edited source never
loads a stale build.  The compiler writes to a per-process temporary name
that is renamed into place, so concurrent test workers may build at once.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from typing import Callable, List

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build")


def nvcc() -> str:
    """The CUDA compiler: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin); the CUDA kernels cannot "
                           "be built")
    return path


def build_shared_library(src: str, stem: str,
                         command: Callable[[str], List[str]],
                         timeout: float = 600.0) -> str:
    """Compile `src` with `command(out_path)` unless a build of the same
    source and command exists; return the library's path.  The compiler's
    output is kept beside it as ``<path>.log``.  Raises RuntimeError with
    that output when the build fails."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(command("OUT")).encode())
    path = os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:12]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = command(tmp)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {os.path.basename(src)} failed "
                f"(exit {proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
        with open(path + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path
