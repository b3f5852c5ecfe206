"""Paged attention kernels for the H100, with their plain PyTorch versions.

Two hand-written CUDA kernels (``csrc/``) carry the continuous-batching
path's attention:

* ``paged_decode_attention`` — one query token per sequence against the
  page-table-indirected KV pool (replaces the TPU kernel
  ``repro/kernels/decode_attention.py::paged_decode_attention``);
* ``chunk_prefill_attention`` — a fixed-size prefill chunk against the pool,
  causal by absolute position (replaces ``chunk_prefill_attention`` there).

Each wrapper takes the plain version only for tensors that lie on the CPU.
For a CUDA tensor it launches its kernel, or raises on a dtype, head width
or layout the kernel does not take; there is no fallback. Each wrapper
counts its launches in a plain integer attribute (``.launches``).

Both kernels are memory bound on the H100 (KV bytes); the source notes in
``csrc/*.cu`` say what the design does about it.

Build: ``nvcc`` compiles each ``.cu`` into its own shared library under
``build/repro_torch/`` at first use, keyed by a hash of the sources, and
the library is loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds). All sources build in parallel.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

NEG_INF = -1e30

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
_HEADERS = ("paged_attention.cuh", "dispatch.cuh")
_SOURCES = {"paged_decode_attention": "paged_decode_attention.cu",
            "chunk_prefill_attention": "chunk_prefill_attention.cu"}
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# dtype codes of repro_paged::DType (csrc/paged_attention.cuh)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.int8: 3}
_Q_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_HEAD_DIMS = (64, 128)
_LIBS: Dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    # q, k, v, page_table, seq_lens, k_scale, v_scale, out,
    # B, H, Hkv, dh, ps, n_pp, n_pages, q_dtype, kv_dtype, scale, stream
    "paged_decode_attention": [_P] * 8 + [_I] * 9 + [ctypes.c_float, _P],
    # q, k, v, page_table, start, n_valid, k_scale, v_scale, out,
    # B, C, H, Hkv, dh, ps, n_pp, n_pages, q_dtype, kv_dtype, scale, stream
    "chunk_prefill_attention": [_P] * 9 + [_I] * 10 + [ctypes.c_float, _P],
}


# ------------------------------- build --------------------------------- #

def _source_hash(name: str) -> str:
    h = hashlib.sha256()
    for f in (_SOURCES[name], *_HEADERS):
        h.update((_CSRC / f).read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return _BUILD / f"{name}_{_source_hash(name)}.so"


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
    todo = {n: _lib_path(n) for n in _SOURCES if not _lib_path(n).exists()}
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
            [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(_CSRC / _SOURCES[name])],
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
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_kernels()
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


# ---------------------------- validation -------------------------------- #

def _check(q, k_pages, v_pages, k_scale, v_scale, ints, *, q_ndim: int):
    """Raise on anything the CUDA kernels do not take."""
    if q.dim() != q_ndim or k_pages.dim() != 4:
        raise ValueError(f"q must be {q_ndim}-D and the pools 4-D, got "
                         f"{tuple(q.shape)} and {tuple(k_pages.shape)}")
    dh = q.shape[-1]
    if dh not in _HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not supported by the CUDA kernels "
                         f"(supported: {_HEAD_DIMS})")
    if q.dtype not in _Q_DTYPES:
        raise ValueError(f"query dtype {q.dtype} not supported")
    if k_pages.dtype not in _DTYPE_CODE or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"pool dtypes {k_pages.dtype}/{v_pages.dtype} not "
                         f"supported")
    if k_pages.shape != v_pages.shape or k_pages.shape[-1] != dh:
        raise ValueError("k/v pools must share one shape ending in head_dim")
    H, Hkv = q.shape[-2], k_pages.shape[2]
    if H % Hkv:
        raise ValueError(f"n_heads {H} is not a multiple of n_kv_heads {Hkv}")
    quant = k_pages.dtype == torch.int8
    if quant != (k_scale is not None) or (v_scale is None) != (k_scale is None):
        raise ValueError("int8 pools need k_scale and v_scale (and only they)")
    tensors = [q, k_pages, v_pages, *ints]
    if quant:
        for s in (k_scale, v_scale):
            if s.dtype != torch.float32 or s.shape != (Hkv,):
                raise ValueError(f"scales must be f32 ({Hkv},), got "
                                 f"{s.dtype} {tuple(s.shape)}")
        tensors += [k_scale, v_scale]
    for t in tensors:
        if t.device != q.device:
            raise ValueError("all operands must lie on the query's device")
        if not t.is_contiguous():
            raise ValueError("all operands must be contiguous")
    for t in ints:
        if t.dtype != torch.int32:
            raise ValueError(f"index operands must be int32, got {t.dtype}")
    for t in (k_pages, v_pages):
        if t.data_ptr() % 16:
            raise ValueError("pools must be 16-byte aligned")


def _on_cuda(q) -> bool:
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return True


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# ------------------------------ decode ---------------------------------- #

def _probs(s):
    """Unnormalised probabilities and row sums of masked f32 scores s
    (NEG_INF where masked), with the kernels' convention that a masked
    score contributes exactly 0 (a fully masked row then gives 0, not a
    uniform mean)."""
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s <= NEG_INF / 2, torch.zeros_like(s), torch.exp(s - m))
    return p, p.sum(dim=-1).clamp_min(1e-30)


def _gather(pages, page_table):
    """(n_pages, ps, Hkv, dh) pool + (B, n_pp) table -> (B, n_pp*ps, Hkv, dh)."""
    B, n_pp = page_table.shape
    n_pages, ps, Hkv, dh = pages.shape
    pt = page_table.long()
    pt = torch.where((pt >= 0) & (pt < n_pages), pt, 0)   # as the kernels do
    return pages[pt].reshape(B, n_pp * ps, Hkv, dh)


def _dequant(pages, page_table, scale):
    x = _gather(pages, page_table).float()
    if scale is not None:
        x = x * scale.float()[None, None, :, None]
    return x


def paged_decode_attention_plain(q, k_pages, v_pages, page_table, seq_lens,
                                 *, scale: float = None, k_scale=None,
                                 v_scale=None):
    """Plain PyTorch version: gather the pages densely, mask positions
    >= seq_lens[b], softmax in f32. q: (B, H, dh) -> (B, H, dh)."""
    B, H, dh = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    kd = _dequant(k_pages, page_table, k_scale)           # (B, L, Hkv, dh)
    vd = _dequant(v_pages, page_table, v_scale)
    L, Hkv = kd.shape[1], kd.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, dh).float()
    s = torch.einsum("bhgd,blhd->bhgl", qg, kd) * scale
    valid = (torch.arange(L, device=q.device)[None, :]
             < seq_lens.to(q.device)[:, None])             # (B, L)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p, l = _probs(s)
    o = torch.einsum("bhgl,blhd->bhgd", p, vd) / l[..., None]
    return o.reshape(B, H, dh).to(q.dtype)


def paged_decode_attention(q, k_pages, v_pages, page_table, seq_lens, *,
                           scale: float = None, k_scale=None, v_scale=None):
    """Decode attention over a page-table-indirected KV pool.

    q: (B, H, dh); k/v_pages: (n_pages, page_size, Hkv, dh) pooled pages
    (int8 when scales are given, else any of f32/bf16/f16); page_table:
    (B, n_pages_per_seq) int32 physical page ids (entries past a sequence's
    last used page point at the null page 0 and are masked by seq_lens);
    seq_lens: (B,) int32 valid tokens per sequence; k/v_scale: (Hkv,) f32.
    Returns (B, H, dh) in q's dtype."""
    if not _on_cuda(q):
        return paged_decode_attention_plain(
            q, k_pages, v_pages, page_table, seq_lens, scale=scale,
            k_scale=k_scale, v_scale=v_scale)
    _check(q, k_pages, v_pages, k_scale, v_scale, (page_table, seq_lens),
           q_ndim=3)
    B, H, dh = q.shape
    n_pages, ps, Hkv = k_pages.shape[:3]
    if page_table.dim() != 2 or page_table.shape[0] != B or seq_lens.shape != (B,):
        raise ValueError("page_table must be (B, n_pp) and seq_lens (B,)")
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    out = torch.empty_like(q)
    fn = _lib("paged_decode_attention").paged_decode_attention
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), seq_lens.data_ptr(), _ptr(k_scale),
            _ptr(v_scale), out.data_ptr(), B, H, Hkv, dh, ps,
            page_table.shape[1], n_pages, _DTYPE_CODE[q.dtype],
            _DTYPE_CODE[k_pages.dtype], float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"paged_decode_attention launch failed (rc={rc})")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


# ---------------------------- chunk prefill ----------------------------- #

def chunk_prefill_attention_plain(q, k_pages, v_pages, page_table, start,
                                  n_valid, *, scale: float = None,
                                  k_scale=None, v_scale=None):
    """Plain PyTorch version: gather the pages densely; query (b, c) sits at
    absolute position start[b] + c and attends key positions
    < min(start[b] + c + 1, n_valid[b]). q: (B, C, H, dh) -> (B, C, H, dh)."""
    B, C, H, dh = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    kd = _dequant(k_pages, page_table, k_scale)
    vd = _dequant(v_pages, page_table, v_scale)
    L, Hkv = kd.shape[1], kd.shape[2]
    g = H // Hkv
    if isinstance(start, torch.Tensor):
        start = start.to(q.device, torch.int32).reshape(-1).expand(B)
    else:
        start = torch.full((B,), int(start), dtype=torch.int32,
                           device=q.device)
    n_valid = n_valid.to(q.device)
    limit = torch.minimum(start[:, None] + torch.arange(C, device=q.device)
                          + 1, n_valid[:, None])            # (B, C)
    mask = torch.arange(L, device=q.device)[None, None, :] < limit[:, :, None]
    qg = q.reshape(B, C, Hkv, g, dh).float()
    s = torch.einsum("bchgd,blhd->bhgcl", qg, kd) * scale
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p, l = _probs(s)
    o = (torch.einsum("bhgcl,blhd->bchgd", p, vd)
         / l.permute(0, 3, 1, 2)[..., None])
    return o.reshape(B, C, H, dh).to(q.dtype)


def chunk_prefill_attention(q, k_pages, v_pages, page_table, start, n_valid,
                            *, scale: float = None, k_scale=None,
                            v_scale=None):
    """Chunked-prefill attention: a query chunk against the paged pool.

    q: (B, C, H, dh) — one prefill chunk whose queries sit at absolute
    positions [start, start + C); the pool ALREADY holds the chunk's own KV.
    start: int, 0-d or (B,) int32 tensor; n_valid: (B,) int32 total valid
    tokens once the chunk lands (masks the chunk's right-padding). Row
    (c, head) attends key positions < min(start + c + 1, n_valid).
    Returns (B, C, H, dh) in q's dtype."""
    if not _on_cuda(q):
        return chunk_prefill_attention_plain(
            q, k_pages, v_pages, page_table, start, n_valid, scale=scale,
            k_scale=k_scale, v_scale=v_scale)
    B, C, H, dh = q.shape
    if isinstance(start, torch.Tensor):
        start = start.to(q.device, torch.int32).reshape(-1).expand(B)
        start = start.contiguous()
    else:      # a host int: fill on the device (no host-to-device copy)
        start = torch.full((B,), int(start), dtype=torch.int32,
                           device=q.device)
    _check(q, k_pages, v_pages, k_scale, v_scale, (page_table, start, n_valid),
           q_ndim=4)
    n_pages, ps, Hkv = k_pages.shape[:3]
    if page_table.dim() != 2 or page_table.shape[0] != B or n_valid.shape != (B,):
        raise ValueError("page_table must be (B, n_pp) and n_valid (B,)")
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    out = torch.empty_like(q)
    fn = _lib("chunk_prefill_attention").chunk_prefill_attention
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), start.data_ptr(), n_valid.data_ptr(),
            _ptr(k_scale), _ptr(v_scale), out.data_ptr(), B, C, H, Hkv, dh,
            ps, page_table.shape[1], n_pages, _DTYPE_CODE[q.dtype],
            _DTYPE_CODE[k_pages.dtype], float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"chunk_prefill_attention launch failed (rc={rc})")
    chunk_prefill_attention.launches += 1
    return out


chunk_prefill_attention.launches = 0
