"""Build and load the port's CUDA kernels (`csrc/*.cu`).

At first use every source is compiled for Hopper
(`-gencode arch=compute_90a,code=sm_90a`), one `nvcc` per source, all
started together; the objects are linked into one shared library with a
plain C interface, loaded with `ctypes`. The library's name carries a
hash of the sources and flags, so an edited source builds anew and an
unchanged one loads at once. Build outputs go to `build/kernels/` at the
repository root (listed in `.gitignore`).

Every C entry point takes its pointers and the CUDA stream as
`void*` and returns `cudaGetLastError()` right after its launch;
`check` turns a non-zero code into an exception.

`warm` does the first-use work (build or find the library, load it,
create the card's CUDA context, run the caller's routes once) in a
background thread, so that a node's first verify does not pay for it;
`build/kernels/` is also what keeps a built library across processes.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import pathlib
import shutil
import subprocess
import threading

import torch

from tendermint_tpu_torch.utils import shutdown
from tendermint_tpu_torch.utils.log import kv, logger

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

# C entry points: name -> argument types (pointers and the stream are
# c_void_p so ctypes never truncates them to 32 bits)
_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
SIGNATURES = {
    "madd_chain_entries": [_P, _P, _P, _P, _P, _I64, _I64, _P],
    "madd_chain_fused": [_P, _P, _P, _P, _I64, _I64, _P],
    "ladder": [_P, _P, _P, _P, _P, _I64, _P],
    "finish_encode_compare": [_P, _P, _P, _I64, _I64, _P, ctypes.c_int, _P, _I64, ctypes.c_int, _P, _P],
    "sha256_masked": [_P, _P, _P, _I64, _I64, _P],
    "ripemd160_masked": [_P, _P, _P, _I64, _I64, _P],
    "sha512_masked": [_P, _P, _P, _I64, _I64, _P],
    "merkle_level": [_P, _P, _P, _I64, _I64, ctypes.c_int, ctypes.c_int, _P],
}

_LIB: ctypes.CDLL | None = None
_LOCK = threading.Lock()
# what a failed `warm` raised, for the next `kernel_lib` call to raise
_WARM_ERROR: BaseException | None = None
# what the last build printed (ptxas register/spill lines with verbose=True)
BUILD_LOG: list[str] = []
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(extra: list[str]) -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS + extra).encode())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands concurrently; raise with their output if any fails."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    outs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        outs.append(out)
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return outs


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the kernels (if this source set is not built yet) and
    return the shared library's path. verbose=True adds `-Xptxas -v`,
    whose register and spill lines land in BUILD_LOG."""
    extra = ["-Xptxas", "-v"] if verbose else []
    out_dir = BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"libtm_kernels_{_digest(extra)}.so"
    if lib_path.exists():
        return lib_path
    nvcc = nvcc_path()
    objs = []
    cmds = []
    for src in _sources():
        obj = out_dir / f"{src.stem}.{os.getpid()}.o"
        objs.append(obj)
        cmds.append(
            [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, *extra, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        )
    BUILD_LOG[:] = _run_all(cmds)
    tmp = out_dir / f"{lib_path.name}.{os.getpid()}.tmp"
    _run_all([[nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)]])
    os.replace(tmp, lib_path)  # atomic: a concurrent build never sees half a file
    for obj in objs:
        obj.unlink(missing_ok=True)
    return lib_path


def kernel_lib(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built at first use. Raises the error of
    a failed `warm` once, then builds anew."""
    global _LIB, _WARM_ERROR
    with _LOCK:
        if _WARM_ERROR is not None:
            err, _WARM_ERROR = _WARM_ERROR, None
            raise RuntimeError(f"the kernel warm-up failed: {type(err).__name__}: {err}") from err
        if _LIB is None:
            lib = ctypes.CDLL(str(build(verbose=verbose)))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def warm(device, first_use=None) -> threading.Thread:
    """Start the kernels' first-use work for the CUDA `device` in a
    daemon thread and return it: build the library (or find it under
    `build/kernels/`) and load it, create the device's CUDA context,
    then run `first_use()` (the caller's small run of its routes, which
    loads the kernels and the torch code they need) and synchronize. A
    verify that needs the library meanwhile waits on `kernel_lib`'s lock
    rather than start a second build. An error is logged and raised by
    the next `kernel_lib` call. An exiting interpreter waits for the
    thread (`utils/shutdown.py`)."""

    def _run() -> None:
        global _WARM_ERROR
        try:
            kernel_lib()
            torch.zeros(1, device=device)
            if first_use is not None:
                first_use()
            torch.cuda.synchronize(device)
        except Exception as e:
            kv(logger("kernels"), logging.ERROR, "kernel warm-up failed", error=f"{type(e).__name__}: {e}"[:200])
            with _LOCK:
                _WARM_ERROR = e

    return shutdown.start_thread(_run, "warm-kernels")


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on `device`, as a pointer value."""
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
