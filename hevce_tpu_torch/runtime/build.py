"""Build-on-first-use of the port's native libraries.

Outputs go to build/hevce_tpu_torch/ at the repository root (git-ignored).
Each build writes a temporary file in that directory and renames it into
place, so parallel test workers that build at once never load a half-written
library. Different libraries may build at the same time.
"""
import collections
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
BUILD_DIR = ROOT / "build" / "hevce_tpu_torch"
_locks = collections.defaultdict(threading.Lock)   # one per library name


def build(src: pathlib.Path, name: str, cmd: list, force: bool = False,
          deps=()):
    """Compile `src` into BUILD_DIR/name with `cmd` (the compiler command
    without its output flag) unless a library newer than `src` and the
    headers `deps` is there, or always with force=True. Returns (library
    path, compiler output; "" when nothing was built)."""
    out = BUILD_DIR / name
    with _locks[name]:
        newest = max(p.stat().st_mtime for p in (src, *deps))
        if not force and out.exists() and out.stat().st_mtime >= newest:
            return out, ""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=name + ".",
                                   suffix=".tmp")
        os.close(fd)
        try:
            r = subprocess.run([*cmd, "-o", tmp], capture_output=True,
                               text=True)
            if r.returncode != 0:
                raise RuntimeError(f"building {src.name} failed "
                                   f"(rc={r.returncode}):\n{r.stdout}"
                                   f"{r.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return out, r.stdout + r.stderr


def nvcc_cmd(src: pathlib.Path) -> list:
    """nvcc for sm_90a into a shared library with a plain C interface,
    ptxas's register, shared-memory and spill report included."""
    return [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", str(src)]


def nvcc() -> str:
    """The CUDA compiler: on PATH, else the toolkit's default location."""
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (needed to build the CUDA kernels)")
    return path
