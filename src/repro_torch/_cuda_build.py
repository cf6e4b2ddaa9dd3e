"""Build and load the port's CUDA kernels (nvcc into a plain-C shared library).

Each ``kernels/csrc/<name>.cu`` compiles on its own into
``build/kernels/<name>-<hash>.so`` at the root of the checkout, where the
hash covers the source and the compiler flags, so an edited source is
rebuilt and an unchanged one is reused.  The library exposes ``extern "C"``
launch functions that take device pointers, sizes and a CUDA stream and
return the ``cudaGetLastError()`` of their launch; it is loaded with
``ctypes`` and links against nothing of PyTorch, which keeps a build to a
few seconds.  Nothing here runs at import: the first kernel launch builds
its library, and :func:`build_all` builds every source at once, one
``nvcc`` process each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import TYPE_CHECKING, Callable, Dict, List, Sequence, Tuple

if TYPE_CHECKING:
    import torch

CSRC = Path(__file__).resolve().parent / "kernels" / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("metronome_fill", "metronome_score")

# sm_90a keeps Hopper's wgmma/setmaxnreg available; -fmad=false keeps every
# multiply and add separately rounded, as the plain PyTorch versions do
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on
    ``PATH``, else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _nvcc_command(name: str, out: Path) -> List[str]:
    return [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
            str(CSRC / f"{name}.cu")]


def build_all() -> Dict[str, str]:
    """Compile every kernel source that has no current library, all
    ``nvcc`` processes started together.  Returns each source's ptxas
    report (registers, shared memory, spills); raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _nvcc_command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    reports = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return reports


def load(name: str, bind: Callable[[ctypes.CDLL], ctypes.CDLL]
         ) -> ctypes.CDLL:
    """The loaded library of ``kernels/csrc/<name>.cu``, built first if
    needed; ``bind`` declares its functions' ctypes signatures once."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all()
            lib = bind(ctypes.CDLL(str(path)))
            _LIBS[name] = lib
        return lib


def check_tensors(kernel: str, device: "torch.device",
                  specs: Sequence[Tuple[str, "torch.Tensor", "torch.dtype",
                                        Tuple[int, ...]]]) -> None:
    """Raise ``ValueError`` unless every ``(name, tensor, dtype, shape)``
    is a contiguous tensor of that dtype and shape on ``device``."""
    for name, t, dtype, shape in specs:
        if t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, "
                             f"expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{kernel}: {name} is {t.dtype}, "
                             f"expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")


def check_launch(kernel: str, rc: int,
                 error_string: Callable[[int], bytes]) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc} "
                           f"({error_string(rc).decode()})")
