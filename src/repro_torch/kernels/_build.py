"""Build, load and launch the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and builds on first use into
its own shared library under ``<repo>/build/repro_torch/``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so csrc/<name>.cu

(no ``--use_fast_math``: the quantizer's division must stay IEEE).  The file
name carries a hash of the source, so an edited kernel is rebuilt and a
stale library is never loaded.  :func:`build` starts one ``nvcc`` per
source, all at once, and waits for all of them.

Libraries load with ``ctypes``.  Every C entry point takes device pointers
and the stream as ``void*``, launches on that stream, allocates nothing and
returns ``cudaGetLastError()``; :func:`launch` raises when that is not 0 and
counts the launch in :data:`LAUNCHES` only when it succeeded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("lorenzo_quant", "symbol_hist", "huffman_encode", "huffman_decode",
           "group_hist", "enhancer_fused")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# launches of each kernel since the last reset_launches(); keys are the
# wrapper names ops.py exposes (ops.LAUNCHES is this dict)
LAUNCHES = {"lorenzo_quant_tiles": 0, "lorenzo_quant": 0, "symbol_hist": 0,
            "huffman_encode": 0, "huffman_decode": 0, "group_hist": 0, "enhancer_fused": 0}
BUILD_LOG: dict[str, str] = {}  # source name -> nvcc/ptxas output of its build

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[tuple[str, str], object] = {}


def reset_launches() -> None:
    with _LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every named source whose library is missing, one ``nvcc``
    each, all started together.  Returns seconds per compiled source;
    raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    took, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return took


def _library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                path = _lib_path(name)
                if not path.exists():
                    build((name,))
                lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


def launch(counter: str, source: str, fn: str, argtypes, *args) -> None:
    """Call C entry ``fn`` of ``csrc/<source>.cu`` and count one launch of
    ``counter``.  ``argtypes`` are the ctypes types of ``args`` (pointers and
    the stream as ``c_void_p``: a plain int would be cut to 32 bits)."""
    f = _FUNCS.get((source, fn))
    if f is None:
        f = getattr(_library(source), fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
        _FUNCS[(source, fn)] = f
    err = f(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {fn} failed to launch: cudaError {err}")
    with _LOCK:
        LAUNCHES[counter] += 1
