"""Build and load the hand-written CUDA kernels.

Each source under `csrc/` has a plain C interface (its `*_launch` function
returns the launch's `cudaError_t`) and is compiled by `nvcc -shared` into
its own library under `build/torch_kernels/` at the repository root, then
loaded with ctypes. All sources compile at once, one `nvcc` each, started
together. A library is named after its source's content hash, so an
unchanged source is not rebuilt, and a finished build is moved into place
atomically, so concurrent processes never load a half-written file.

Nothing here runs at import: `load()` is called by the kernel wrappers at
their first launch on a CUDA tensor, and by `chip_smoke.py` to time the
build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
# C signature of every source's launcher: (argtypes, name)
SIGNATURES = {
    "modmatmul": ("ring_matmul_launch",
                  [_P, _I32, _I32, _P, _I32, _I32, _P, _I64, _I64, _I64,
                   _I32, _I64, _I32, _I32, _P]),
    "ksadder": ("ks_carry_share_launch",
                [_P] * 5 + [_P, _I64] * 5 + [_P, _I64, _I32, _I32, _I32, _P]),
    "spmm": ("spmm_ell_launch",
             [_P] * 5 + [_I64, _I64, _I32, _I32, _I32, _I64, _I32, _I32, _I32,
                         _I32, _I32, _I32, _I64, _I32, _I32, _I32, _I32,
                         _I32, _I32, _I32, _I64, _I64, _I32, _P]),
    "esd": ("esd_launch", [_P, _P, _P, _I64, _I32, _I32, _I32, _I32, _I32,
                           _P]),
    "argmin": ("argmin_onehot_launch", [_P, _P, _I64, _I32, _I32, _P]),
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
# compiler output (register/shared-memory use from -Xptxas=-v) per source
BUILD_LOG: dict[str, str] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = pathlib.Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels are built on first use and need "
            "the CUDA toolkit")
    return found


def _lib_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(ARCH_FLAGS + NVCC_FLAGS)
                            .encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def load() -> dict[str, ctypes.CDLL]:
    """Build (where needed) and load every kernel library; returns
    {source name: CDLL} with each launcher's argtypes/restype set."""
    with _LOCK:
        if len(_LIBS) == len(SIGNATURES):
            return _LIBS
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = {n: _lib_path(n) for n in SIGNATURES}
        procs = {}
        for name, path in todo.items():
            if path.exists():
                continue
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, path)
        failed = []
        for name, (proc, tmp, path) in procs.items():
            out, _ = proc.communicate()
            BUILD_LOG[name] = out
            if proc.returncode != 0:
                failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
                continue
            os.replace(tmp, path)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        for name, path in todo.items():
            lib = ctypes.CDLL(str(path))
            fn_name, argtypes = SIGNATURES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _LIBS[name] = lib
        return _LIBS


def launcher(name: str):
    """The C launch function of source `name`, building on first use."""
    return getattr(load()[name], SIGNATURES[name][0])


def check(err: int, what: str) -> None:
    """Raise if a launch was refused (the C launcher's cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
