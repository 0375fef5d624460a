"""Kernel build, load and device report for the CUDA kernels of the port.

The hand-written Hopper kernels live in ``spsparse_torch/csrc/*.cu`` behind
a plain C interface. On first use each source is compiled by its own
``nvcc`` process, all started together, and the objects are linked into one
shared library, which is loaded with :mod:`ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC
         -c spsparse_torch/csrc/<name>.cu -o <name>.o       (one per source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o spsparse_torch/_kernels/<hash>/libspsparse_kernels.so *.o

The build directory is keyed by a hash of the sources and flags, so an
edited kernel is rebuilt and an unchanged one is loaded as it is. Nothing is
built or loaded when this module is imported: the CPU tests import every
module, and only a CUDA tensor that needs a kernel triggers the build.

Every C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` raises when that is not ``cudaSuccess``. There is no switch
that forces the plain PyTorch versions: a wrapper takes its plain version
only because the tensor it was given lies on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = ["CSRC_DIR", "KERNEL_DIR", "NVCC_FLAGS", "find_nvcc", "build",
           "load_kernels", "check", "device_report"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
KERNEL_DIR = Path(__file__).resolve().parent / "_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")
_LIB_NAME = "libspsparse_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# C signatures (csrc/*.cu). Pointers and the stream are c_void_p so that
# ctypes never truncates a 64-bit address to a 32-bit int.
_SIGNATURES = {
    "sps_dia_spmv": [_I, _P, _LL, _LL, _LL, _I, _P, _P, _P, _F, _P],
    "sps_dia_chain": [_I, _P, _LL, _LL, _I, _P, _P, _P, _I, _F, _P],
    "sps_dia_max_diags": [],
    "sps_dia_mrhs": [_I, _P, _LL, _LL, _LL, _I, _P, _I, _P, _LL, _P, _LL,
                     _P],
    "sps_dia_cg": [_I, _P, _LL, _LL, _I, _P, _F, _P, _P, _P, _P, _P, _P, _P,
                   _LL, _P, _P, _I, _P],
    "sps_tiled_dense": [_I, _P, _P, _I, _I, _I, _P, _LL, _I, _P, _LL, _P],
    "sps_tiled_window": [_I, _P, _P, _P, _I, _I, _I, _P, _LL, _I, _P, _LL,
                         _P],
    "sps_tiled_onehot": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _LL, _I, _P, _LL,
                         _P],
    "sps_spgemm_pairs": [_I, _I, _P, _P, _P, _P, _P, _I, _P, _P],
    "sps_spgemm_pairs_stream": [_I, _I, _P, _P, _P, _P, _P, _I, _P, _P],
    "sps_spgemm_window": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _I, _I, _P, _P],
    "sps_segsum": [_P, _P, _LL, _I, _P, _P],
    "sps_shuffle_gather": [_I, _P, _P, _P, _P, _P, _LL, _LL, _P, _LL, _LL,
                           _P, _P],
    "sps_block_sort": [_P, _P, _I, _I, _LL, _LL, _P],
}


def find_nvcc() -> str | None:
    """Path of ``nvcc`` on ``PATH`` or under the default toolkit prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    return str(default) if default.exists() else None


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into the hash-keyed library (no-op if built).

    The sources compile in parallel, one ``nvcc`` each. Raises
    ``RuntimeError`` when ``nvcc`` is missing or a compile fails. The library
    is linked in a temporary directory and renamed into place, so a build
    cut off halfway never leaves a library that loads.
    """
    out_dir = KERNEL_DIR / _source_hash()
    lib = out_dir / _LIB_NAME
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "spsparse_torch: a CUDA tensor needs a kernel, but nvcc was not "
            "found on PATH or at /usr/local/cuda/bin/nvcc")
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
        objs, procs = [], []
        for src in sorted(CSRC_DIR.glob("*.cu")):
            obj = os.path.join(tmp_dir, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
                   "-o", obj]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        logs = []
        for cmd, proc in procs:
            out, err = proc.communicate()
            logs.append((cmd, proc.returncode, out, err))
        tmp_lib = os.path.join(tmp_dir, _LIB_NAME)
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp_lib, *objs]
        if all(log[1] == 0 for log in logs):
            proc = subprocess.run(link, capture_output=True, text=True)
            logs.append((link, proc.returncode, proc.stdout, proc.stderr))
        for cmd, code, _, err in logs:
            if code != 0:
                raise RuntimeError(
                    "spsparse_torch: nvcc failed (exit %d)\n%s\n%s"
                    % (code, " ".join(cmd), err))
            if verbose:
                print(err, end="")
        os.replace(tmp_lib, lib)
    return lib


@functools.cache
def load_kernels() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; argtypes are set."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(
            f"spsparse_torch: {what} failed with CUDA error {err} "
            f"({_error_string(err)})")


def _error_string(err: int) -> str:
    try:
        cudart = ctypes.CDLL("libcudart.so")
    except OSError:
        return "cudaGetErrorString unavailable"
    cudart.cudaGetErrorString.restype = ctypes.c_char_p
    cudart.cudaGetErrorString.argtypes = [ctypes.c_int]
    return cudart.cudaGetErrorString(err).decode()


def current_stream(device: torch.device) -> int:
    """PyTorch's current CUDA stream handle on ``device`` (a Python int)."""
    return torch.cuda.current_stream(device).cuda_stream


def device_report() -> dict:
    """Which device the port would run on, and whether kernels can build."""
    cuda = torch.cuda.is_available()
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": cuda,
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 0,
        "nvcc": find_nvcc(),
    }
