"""Build the port's CUDA sources with nvcc and bind them through ctypes.

Each ``probpose_code_torch/csrc/<name>.cu`` compiles, at first use, into a
shared library with a plain C interface under ``build/torch_kernels/`` at
the repository root (listed in ``.gitignore``). A source may add flags of its
own (``SOURCE_FLAGS``: nvJPEG's yardstick links nvJPEG). The file name
carries a hash of the source, of every shared header ``csrc/*.cuh`` and of
the flags that nvcc is given (``flags``), so an edited source, header or
flag is rebuilt and an unchanged one is reused. Nothing
here touches CUDA when the module is imported: the CPU tests import every
module of the package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, Dict, Iterable, List, Tuple, Union

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]


def _cuda_lib() -> str:
    """The toolkit's library directory, beside the nvcc that builds."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return str(Path(nvcc).resolve().parents[1] / "lib64")


# flags one source adds after ``NVCC_FLAGS``: nvJPEG, found at run time where
# it was linked
SOURCE_FLAGS = {"nvjpeg_batched": ["-lnvjpeg", "-Xlinker", f"-rpath={_cuda_lib()}"]}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def flags(name: str) -> List[str]:
    """nvcc's flags for ``csrc/<name>.cu``, given after the source (the
    libraries follow it) and hashed into its library's name."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, [])


def _target(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source unless its library exists; returns the
    process (or None) and the target path."""
    out = _target(name)
    if out.exists():
        return None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), str(CSRC / f"{name}.cu"), "-o", str(tmp), *flags(name)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return (proc, tmp), out


def _finish(started, out: Path) -> None:
    if started is None:
        return
    proc, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
    os.replace(tmp, out)


def build(names: Iterable[str]) -> List[Path]:
    """Compile the named sources, one nvcc process each, all at once."""
    names = list(names)
    with _lock:
        started = [_start(n) for n in names]
        errors = []
        for s, out in started:  # every nvcc is waited for, then the first failure raises
            try:
                _finish(s, out)
            except RuntimeError as e:
                errors.append(e)
        if errors:
            raise errors[0]
    return [out for _, out in started]


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def load(name: str, signatures: Dict[str, Union[list, Tuple[list, Any]]]) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; declare every entry's
    argument types (pointers and the stream as ``c_void_p``) and its return
    type: an int return code, or the type given as ``(argtypes, restype)``."""
    with _lock:
        lib = _libs.get(name)
    if lib is not None:
        return lib
    (path,) = build([name])
    lib = ctypes.CDLL(str(path))
    for fn, spec in signatures.items():
        argtypes, restype = spec if isinstance(spec, tuple) else (spec, ctypes.c_int)
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    with _lock:
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, prefix: str, code: int) -> None:
    """Raise on a non-zero CUDA error code returned by a C entry."""
    if code != 0:
        getter = getattr(lib, f"{prefix}_error_string")
        getter.restype = ctypes.c_char_p
        getter.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{prefix} kernel failed: CUDA error {code} ({getter(code).decode()})")


def stream_of(tensor) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(tensor.device).cuda_stream)


def ptr(tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(tensor.data_ptr())
