"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles every source for Hopper (``sm_90a``) into one shared
library with a plain C interface, ``build/kernels/librepro_kernels-<hash>.so``
at the repository root, keyed by a hash of the sources: the first use after
a checkout or an edit builds it (a few seconds; one ``nvcc`` per source, all
started together, then one link), later uses load it. ``ctypes`` binds it;
pointers and the stream go over as ``c_void_p``.

Nothing here runs at import: the CPU tests import every module, and nothing
needs ``nvcc`` or a card until a kernel launches on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_REPO = Path(__file__).resolve().parents[3]
BUILD_DIR = _REPO / "build" / "kernels"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

# The C entries that are no kernel: (argtypes, restype). The kernels' come
# from repro_torch.kernels.ops.KERNELS.
UTILITIES = {
    "repro_kernel_attributes": ((ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p), ctypes.c_int),
    "repro_error_string": ((ctypes.c_int,), ctypes.c_char_p),
}


def entries() -> Dict[str, Tuple[tuple, type]]:
    """Every C entry the library exports: ``repro_<name>`` of each kernel
    of ``KERNELS`` (returning its launch's ``cudaError_t``), then
    :data:`UTILITIES`."""
    from .ops import KERNELS
    return {**{f"repro_{k.name}": (k.argtypes, ctypes.c_int)
               for k in KERNELS}, **UTILITIES}


def sources() -> List[Path]:
    return sorted(_CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(_CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"librepro_kernels-{source_hash()}.so"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels are built with nvcc at first use")
    return path


def build() -> Tuple[Path, str]:
    """Compile and link the kernels if the library for these sources is not
    there yet. Returns (library path, the compiler's output)."""
    lib = library_path()
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [exe, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = []
        for src, proc in zip(sources(), procs):
            out, _ = proc.communicate()
            logs.append(out)
            if proc.returncode != 0:
                for other in procs:
                    other.kill()
                    other.wait()
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        staged = Path(tmp) / lib.name
        link = subprocess.run(
            [exe, *ARCH_FLAGS, "-shared", "-o", str(staged), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(staged, lib)
    return lib, "".join(logs) + link.stdout


_LIB: Optional[ctypes.CDLL] = None
_LOAD_LOCK = threading.Lock()


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first use. Two threads whose
    first launches race (the serving worker and the caller's thread) build
    and load it once: the first takes the lock, the other waits for it."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOAD_LOCK:
        if _LIB is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, (argtypes, restype) in entries().items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _LIB = lib
    return _LIB


def check(lib: ctypes.CDLL, rc: int, kernel: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        msg = lib.repro_error_string(rc).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc} ({msg})")


def launch(name: str, device: torch.device, *args) -> None:
    """Launch the kernel ``name`` on ``device``: call ``repro_<name>(*args,
    stream)`` on the device's current stream, raise if it returned a CUDA
    error, and count the launch (``ops.launch_counts()``)."""
    from . import ops
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, f"repro_{name}")(*args, stream)
    check(lib, rc, name)
    ops._LAUNCHES[name] += 1
