"""Build-on-first-use of the port's native libraries.

Outputs go to build/hevce_tpu_torch/ at the repository root (git-ignored).
A library's file name carries a hash of what it is built from: the
source's contents, the contents of the headers it lists, and the compiler
command, flags included (libhevce_k2.so is built as
libhevce_k2.<hash12>.so). A changed source, header or flag therefore names
another file and builds it, whatever the files' times say; an untouched
tree finds its library and builds nothing. Each build writes a temporary
file in that directory and renames it into place, so parallel test
workers that build at once never load a half-written library. Different
libraries may build at the same time.
"""
import collections
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
BUILD_DIR = ROOT / "build" / "hevce_tpu_torch"
_locks = collections.defaultdict(threading.Lock)   # one per library file


def key(src: pathlib.Path, cmd: list, deps=()) -> str:
    """12 hex digits of the SHA-256 of the compiler command and the
    contents of `src` and of each header in `deps`, in that order."""
    h = hashlib.sha256("\0".join(map(str, cmd)).encode())
    for p in (src, *deps):
        h.update(b"\0" + pathlib.Path(p).read_bytes())
    return h.hexdigest()[:12]


def build(src: pathlib.Path, name: str, cmd: list, force: bool = False,
          deps=()):
    """Compile `src` with `cmd` (the compiler command without its output
    flag) into BUILD_DIR, as `name` with key()'s hash before its suffix,
    unless that file is there, or always with force=True. Returns (library
    path, compiler output; "" when nothing was built)."""
    stem, dot, suffix = name.partition(".")
    out = BUILD_DIR / f"{stem}.{key(src, cmd, deps)}{dot}{suffix}"
    with _locks[out.name]:
        if not force and out.exists():
            return out, ""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=out.name + ".",
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
