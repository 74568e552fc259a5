"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C entry point, which
may include the headers (``csrc/*.cuh``) beside it.  At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``<repo>/build/kernels`` (listed in ``.gitignore``), named by the hash of
the source and the headers, and loaded through ``ctypes``.  Nothing is
built when a module is imported, so the CPU tests can import every
kernel module without a toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
# <repo>/build/kernels: listed in .gitignore, built at first use.
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

_libs: Dict[Path, ctypes.CDLL] = {}
_lock = threading.Lock()

# The most shared memory a block may ask for on an H100 (sm_90's opt-in
# limit, 227 KB; the sources' ``kMaxSmemBytes``): static and dynamic
# together.
SMEM_PER_BLOCK = 232448


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source and need the CUDA toolkit")


def content_tag(source: Path) -> str:
    """Hash of ``source`` and of every header (``*.cuh``) in its
    directory, which it may include: a header change rebuilds."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return h.hexdigest()[:12]


def build(source: Path) -> Path:
    """Compile ``source`` into ``BUILD_DIR`` (once per content of the
    source and of the headers beside it) and return the shared library's
    path.  The compiler's register and shared-memory report (``-Xptxas
    -v``) is kept beside it as ``.log``."""
    tag = content_tag(source)
    out = BUILD_DIR / f"lib{source.stem}_{tag}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} "
                           f"({proc.returncode}):\n{proc.stdout}\n"
                           f"{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load(source: Path, declare: Callable[[ctypes.CDLL], None]
         ) -> ctypes.CDLL:
    """The loaded library of ``source``, built on first call; ``declare``
    sets its functions' ``argtypes``/``restype`` once."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            declare(lib)
            _libs[source] = lib
        return lib


def smem_report(lib: ctypes.CDLL, prefix: str) -> List[Tuple[str, int, int]]:
    """[(instance, static bytes, dynamic bytes)] of every kernel instance
    in a loaded library, from its ``<prefix>_smem``: the static bytes the
    compiler gave the kernel (``cudaFuncGetAttributes``) and the dynamic
    bytes its launches ask for at most."""
    fn = getattr(lib, f"{prefix}_smem")
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
                   ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    rows, i = [], 0
    while True:
        name, st, dyn = ctypes.c_char_p(), ctypes.c_int(), ctypes.c_int()
        err = fn(i, ctypes.byref(name), ctypes.byref(st), ctypes.byref(dyn))
        if err == -1:
            return rows
        if err != 0:
            raise RuntimeError(f"{prefix}: reading instance {i}'s "
                               f"attributes failed (cudaError {err})")
        rows.append((name.value.decode(), st.value, dyn.value))
        i += 1
