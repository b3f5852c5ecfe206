"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exports one C function ``<name>`` and is compiled
by ``nvcc`` for ``sm_90a`` into its own shared library under
``build/repro_torch/`` at first use, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). A library's file name carries a hash
of its source, of the headers it includes (followed transitively through
``#include "..."``) and of the compiler flags, so an edited source or
header rebuilds exactly the libraries that use it. ``build_kernels``
compiles every missing library at once, one ``nvcc`` per source, all in
parallel, each spreading its kernels over threads (``--split-compile``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# kernel name -> its source in csrc/
SOURCES = {name: f"{name}.cu" for name in (
    "paged_decode_attention", "chunk_prefill_attention", "decode_attention",
    "flash_attention")}
# --split-compile: each nvcc optimizes and assembles its kernels on up to 8
# threads (the paged decode's 108 instances are the longest build)
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "--split-compile=8", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v")
_INCLUDE = re.compile(r'^\s*#include\s+"([^"]+)"', re.MULTILINE)
_FNS: Dict[str, ctypes._CFuncPtr] = {}


def headers(name: str) -> List[str]:
    """The csrc/ headers that kernel ``name``'s source includes, directly or
    through another header, in the order first reached."""
    seen: List[str] = []
    todo = [SOURCES[name]]
    while todo:
        for inc in _INCLUDE.findall((_CSRC / todo.pop()).read_text()):
            if inc not in seen:
                seen.append(inc)
                todo.append(inc)
    return seen


def source_hash(name: str) -> str:
    h = hashlib.sha256()
    for f in (SOURCES[name], *headers(name)):
        h.update(f.encode())
        h.update((_CSRC / f).read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return _BUILD / f"{name}_{source_hash(name)}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc); set CUDA_HOME")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build_kernels() -> Dict[str, float]:
    """Compile every kernel whose library is missing, all in parallel (one
    ``nvcc`` per source). Returns {kernel: seconds} for the builds run;
    each build's compiler output (``-Xptxas -v``: registers, shared
    memory, spills) is kept beside its library as ``.log``."""
    todo = {n: lib_path(n) for n in SOURCES if not lib_path(n).exists()}
    if not todo:
        return {}
    _BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        log = open(path.with_suffix(".log"), "w")
        procs[name] = (subprocess.Popen(
            [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(_CSRC / SOURCES[name])],
            stdout=log, stderr=subprocess.STDOUT), tmp, path, log)
    secs = {}
    failed = []
    for name, (proc, tmp, path, log) in procs.items():
        rc = proc.wait()
        log.close()
        secs[name] = time.perf_counter() - t0
        if rc:
            failed.append(f"{name} (rc={rc}, see {path.with_suffix('.log')})")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed: " + "; ".join(failed))
    return secs


def build_log(name: str) -> str:
    """The compiler output of ``name``'s current build ('' if none)."""
    log = lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def kernel(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of its library (built first if missing),
    with its argument types set and an int return code."""
    fn = _FNS.get(name)
    if fn is None:
        path = lib_path(name)
        if not path.exists():
            build_kernels()
        fn = getattr(ctypes.CDLL(str(path)), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn
