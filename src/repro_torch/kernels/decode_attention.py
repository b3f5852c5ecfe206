"""Attention kernels over the KV cache for the H100, with their plain
PyTorch versions.

Three hand-written CUDA kernels (``csrc/``) carry the serving paths'
cache attention, reached through four entries:

* ``paged_decode_attention`` — one query token per sequence against the
  page-table-indirected KV pool (replaces the TPU kernel
  ``repro/kernels/decode_attention.py::paged_decode_attention``);
* ``chunk_prefill_attention`` — a fixed-size prefill chunk against the pool,
  causal by absolute position (replaces ``chunk_prefill_attention`` there);
* ``spec_verify_attention`` — the speculative verify window, a per-sequence
  start and per-row frontier (replaces ``spec_verify_attention`` there,
  which is the chunk kernel's ``pallas_call`` with ``start=seq_lens``; here
  too it launches the chunk kernel);
* ``decode_attention`` — one query token per sequence against a dense
  ``(B, L, Hkv, dh)`` cache, masked at a per-row valid length: the static
  engine's decode (replaces ``decode_attention`` there).

Every kernel here, and flash attention (``flash_attention.py``), takes
head widths 64, 128, 256, 384 and 512 (``_HEAD_DIMS``): paligemma-3b's and
gemma3-1b's 256 as well as the common 64 and 128, and every multiple of
128 up to 512 that the reference's routes take. Wider heads are refused
(ROADMAP B8).

Each wrapper takes the plain version only for tensors that lie on the CPU.
For a CUDA tensor it launches its kernel, or raises on a dtype, head width
or layout the kernel does not take; there is no fallback. Each wrapper
counts its launches in a plain integer attribute (``.launches``), and in
``.launches_by_heads`` by the KV heads of the pool or cache it was given
(a head shard's pool holds Hkv/N of them).

The paged decode splits the page table's keys across blocks, whole pages
a split, with a body of its own for one to a few query rows; the chunk
kernel (chunk prefill and spec verify) runs bf16/f16 queries on
tensor-core tiles and splits the page table's keys too; the dense decode
splits its key walk across blocks (split-K). Each split kernel is two
launches a call where there is more than one split, with the split size a
function of the shapes and the SM count (``paged_split``, ``chunk_split``,
``decode_split``), so no wrapper reads the device. The source notes in
``csrc/*.cu`` say what each design does and what bounds it (PERF.md has
their times on the H100). ``kernels.build`` compiles and loads them.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels.build import kernel

NEG_INF = -1e30

# dtype codes of repro_paged::DType (csrc/paged_attention.cuh)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.int8: 3}
_Q_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# head widths every kernel is built for (csrc/dispatch.cuh)
_HEAD_DIMS = (64, 128, 256, 384, 512)

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    # q, k, v, page_table, seq_lens, k_scale, v_scale, part, out,
    # B, H, Hkv, dh, ps, n_pp, n_pages, split, n_split, q_dtype, kv_dtype,
    # scale, stream
    "paged_decode_attention": [_P] * 9 + [_I] * 11 + [ctypes.c_float, _P],
    # q, k, v, page_table, start, start0, n_valid, n_fed, k_scale, v_scale,
    # part, out, B, C, H, Hkv, dh, ps, n_pp, n_pages, split, n_split,
    # q_dtype, kv_dtype, scale, stream
    "chunk_prefill_attention": ([_P] * 5 + [_I] + [_P] * 6 + [_I] * 12
                                + [ctypes.c_float, _P]),
    # q, k_cache, v_cache, kv_valid, k_scale, v_scale, part, out,
    # B, H, Hkv, dh, L, split, n_split, q_dtype, kv_dtype, scale, stream
    "decode_attention": [_P] * 8 + [_I] * 9 + [ctypes.c_float, _P],
}


def _fn(name: str):
    return kernel(name, _ARGTYPES[name])


# ---------------------------- validation -------------------------------- #

def _check(q, k_pages, v_pages, k_scale, v_scale, ints, *, q_ndim: int):
    """Raise on anything the CUDA kernel does not take. k/v_pages: the K/V
    pools, dense caches or key/value tensors (4-D, kv heads on dim 2)."""
    if q.dim() != q_ndim or k_pages.dim() != 4:
        raise ValueError(f"q must be {q_ndim}-D and the pools 4-D, got "
                         f"{tuple(q.shape)} and {tuple(k_pages.shape)}")
    dh = q.shape[-1]
    if dh not in _HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not supported by this CUDA kernel "
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


# ------------------------------ plain math ------------------------------ #

@functools.lru_cache(maxsize=None)
def _cpu_exp_ready() -> bool:
    torch.exp(torch.zeros(8))      # one thread: below one parallel grain
    return True


def _exp(x):
    """torch.exp of the plain versions. On the CPU, the first parallel call
    in a process of the vector exp behind it (oneMKL's, in PyTorch's MKL
    builds) can come out about 1e-4 off when its threads enter it
    together; later calls are accurate to f32. One small call on one
    thread first keeps every call of the plain versions accurate
    (tests/test_torch_first_exp.py)."""
    if x.device.type == "cpu":
        _cpu_exp_ready()
    return torch.exp(x)


def _probs(s):
    """Unnormalised probabilities and row sums of masked f32 scores s
    (NEG_INF where masked), with the kernels' convention that a masked
    score contributes exactly 0 (a fully masked row then gives 0, not a
    uniform mean)."""
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s <= NEG_INF / 2, torch.zeros_like(s), _exp(s - m))
    return p, p.sum(dim=-1).clamp_min(1e-30)


def _dequant_dense(x, scale):
    """(B, L, Hkv, dh) K or V as f32, times its (Hkv,) scale when given."""
    x = x.float()
    if scale is not None:
        x = x * scale.float()[None, None, :, None]
    return x


def _gather(pages, page_table):
    """(n_pages, ps, Hkv, dh) pool + (B, n_pp) table -> (B, n_pp*ps, Hkv, dh)."""
    B, n_pp = page_table.shape
    n_pages, ps, Hkv, dh = pages.shape
    pt = page_table.long()
    pt = torch.where((pt >= 0) & (pt < n_pages), pt, 0)   # as the kernels do
    return pages[pt].reshape(B, n_pp * ps, Hkv, dh)


def _dequant(pages, page_table, scale):
    return _dequant_dense(_gather(pages, page_table), scale)


def _decode_plain(q, kd, vd, valid, *, scale):
    """q (B, H, dh) against dense f32 K/V (B, L, Hkv, dh): sequence b
    attends key positions < valid[b], softmax in f32."""
    B, H, dh = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    L, Hkv = kd.shape[1], kd.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, dh).float()
    s = torch.einsum("bhgd,blhd->bhgl", qg, kd) * scale
    keep = (torch.arange(L, device=q.device)[None, :]
            < valid.to(q.device)[:, None])                  # (B, L)
    s = torch.where(keep[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p, l = _probs(s)
    o = torch.einsum("bhgl,blhd->bhgd", p, vd) / l[..., None]
    return o.reshape(B, H, dh).to(q.dtype)


def _attend_rows_plain(q, kd, vd, hi, *, scale):
    """Query (b, c) of q (B, C, H, dh) attends key positions < hi[b, c] of
    the dense f32 K/V (B, L, Hkv, dh), softmax in f32."""
    B, C, H, dh = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    L, Hkv = kd.shape[1], kd.shape[2]
    g = H // Hkv
    mask = torch.arange(L, device=q.device)[None, None, :] < hi[:, :, None]
    qg = q.reshape(B, C, Hkv, g, dh).float()
    s = torch.einsum("bchgd,blhd->bhgcl", qg, kd) * scale
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p, l = _probs(s)
    o = (torch.einsum("bhgcl,blhd->bchgd", p, vd)
         / l.permute(0, 3, 1, 2)[..., None])
    return o.reshape(B, C, H, dh).to(q.dtype)


# ------------------------------ paged decode ---------------------------- #

def paged_decode_attention_plain(q, k_pages, v_pages, page_table, seq_lens,
                                 *, scale: float = None, k_scale=None,
                                 v_scale=None):
    """Plain PyTorch version: gather the pages densely, mask positions
    >= seq_lens[b], softmax in f32. q: (B, H, dh) -> (B, H, dh)."""
    return _decode_plain(q, _dequant(k_pages, page_table, k_scale),
                         _dequant(v_pages, page_table, v_scale), seq_lens,
                         scale=scale)


_PAGED_SPLIT_MAX = 128   # keys a split at most, before rounding to pages
_PAGED_ROWS = 4          # query rows a pass-1 block takes at most
_PAGED_MAX_SPLIT = 4096  # keys a split the kernel takes (rows in shared memory)


def paged_split(B: int, Hkv: int, n_keys: int, group: int, page_size: int,
                n_sm: int) -> int:
    """Keys a split of the paged decode kernel
    (csrc/paged_decode_attention.cu) over a page table of ``n_keys = n_pp
    * page_size`` keys: a whole number of pages.

    A pure function of the shapes and the card's SM count, never of
    ``seq_lens`` (which lies on the device: reading it would cost a
    device-to-host sync a layer). A pass-1 block takes one split of one
    (sequence, kv head) for up to four of the group's query rows, so the
    card holds ``B * Hkv * ceil(group / 4)`` units of work a split. The
    table is cut into the number of splits that brings that nearest to two
    an SM, and into at least enough that no split exceeds 128 keys; a split
    is then rounded up to whole pages, and ``ceil(n_keys / split)`` splits
    cover the table."""
    units = B * Hkv * -(-group // _PAGED_ROWS)
    n_keys = max(n_keys, 1)
    n_split = max(1, (2 * n_sm + units // 2) // units,
                  -(-n_keys // _PAGED_SPLIT_MAX))
    split = -(-n_keys // n_split)
    return -(-split // page_size) * page_size


def _paged_split_plain(q, k_pages, v_pages, page_table, seq_lens, split: int,
                       *, scale: float = None, k_scale=None, v_scale=None):
    """Plain mirror of the paged decode kernel's two passes, for the tests
    (the plain version of the function is
    ``paged_decode_attention_plain``): the dense decode's split mirror
    (``_decode_split_plain``) over the pages gathered through the table
    (ids outside ``[0, n_pages)`` read the null page 0), at
    ``kv_valid = seq_lens``. Returns out (B, H, dh) in q's dtype and the
    partials (m, l: (B, H, n_split); acc: (B, H, n_split, dh))."""
    return _decode_split_plain(q, _gather(k_pages, page_table),
                               _gather(v_pages, page_table), seq_lens, split,
                               scale=scale, k_scale=k_scale, v_scale=v_scale)


def _split_heads(split_kv_heads, Hkv: int) -> int:
    """The KV-head count the split rules size a call's splits from: the
    operands' own, or ``split_kv_heads`` for a head shard of a pool of that
    many heads (a multiple of the shard's), so that a shard runs the same
    splits, and sums in the same order, as the whole pool."""
    if split_kv_heads is None:
        return Hkv
    if split_kv_heads < Hkv or split_kv_heads % Hkv:
        raise ValueError(f"split_kv_heads ({split_kv_heads}) must be a "
                         f"multiple of the pool's {Hkv} kv heads")
    return split_kv_heads


def paged_decode_attention(q, k_pages, v_pages, page_table, seq_lens, *,
                           scale: float = None, k_scale=None, v_scale=None,
                           split_kv_heads: Optional[int] = None):
    """Decode attention over a page-table-indirected KV pool.

    q: (B, H, dh); k/v_pages: (n_pages, page_size, Hkv, dh) pooled pages
    (int8 when scales are given, else any of f32/bf16/f16); page_table:
    (B, n_pages_per_seq) int32 physical page ids (entries past a sequence's
    last used page point at the null page 0 and are masked by seq_lens);
    seq_lens: (B,) int32 valid tokens per sequence; k/v_scale: (Hkv,) f32.
    Returns (B, H, dh) in q's dtype.

    On the card the page table is cut into splits of ``paged_split(...)``
    keys (pages up to 4096 keys): pass 1 writes each split's partials into
    f32 scratch allocated here, pass 2 combines them in split order
    (bitwise repeatable); with one split, pass 1 writes the output. On a
    head shard (``kernels.sharded``) the operands are the shard's heads and
    ``split_kv_heads`` the whole pool's KV-head count: the split is then
    the whole pool's, and each head's result bitwise the same."""
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
    n_pp = page_table.shape[1]
    split = paged_split(B, _split_heads(split_kv_heads, Hkv), n_pp * ps,
                        H // Hkv, ps, _sm_count(q.device.index))
    if split > _PAGED_MAX_SPLIT:
        raise ValueError(f"page_size {ps} exceeds the paged decode kernel's "
                         f"{_PAGED_MAX_SPLIT}-key split")
    n_split = max(1, -(-(n_pp * ps) // split))
    part = None
    if n_split > 1:
        # pass 1's partials: acc (B, H, n_split, dh), then m and l
        part = torch.empty(B * H * n_split * (dh + 2), dtype=torch.float32,
                           device=q.device)
    out = torch.empty_like(q)
    rc = _fn("paged_decode_attention")(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), seq_lens.data_ptr(), _ptr(k_scale),
        _ptr(v_scale), _ptr(part), out.data_ptr(), B, H, Hkv, dh, ps, n_pp,
        n_pages, split, n_split, _DTYPE_CODE[q.dtype],
        _DTYPE_CODE[k_pages.dtype], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"paged_decode_attention launch failed (rc={rc})")
    # a host counter: CUDA-graph capture runs it once, a replay never
    # repro: allow(traced-purity): P1 adds graph replays to the count
    paged_decode_attention.launches += 1
    paged_decode_attention.launches_by_heads[Hkv] += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.launches_by_heads = collections.Counter()


# ---------------------------- chunk prefill ----------------------------- #

def _attend_chunk_plain(q, k_pages, v_pages, page_table, hi, *, scale,
                        k_scale, v_scale):
    """Gather the pages densely; query (b, c) attends key positions
    < hi[b, c], softmax in f32. q: (B, C, H, dh); hi: (B, C)."""
    return _attend_rows_plain(q, _dequant(k_pages, page_table, k_scale),
                              _dequant(v_pages, page_table, v_scale), hi,
                              scale=scale)


def _start_vector(start, B: int, device) -> torch.Tensor:
    """A scalar or (B,) start as a contiguous (B,) int32 tensor on
    ``device`` (a host int is filled on the device: no host-to-device
    copy)."""
    if isinstance(start, torch.Tensor):
        return start.to(device, torch.int32).reshape(-1).expand(B).contiguous()
    # repro: allow(traced-purity): a host int here; a tensor returned above
    return torch.full((B,), int(start), dtype=torch.int32, device=device)


_CHUNK_STEPS = 4   # stages a split at most: pass 1 walks a split serially


def chunk_on_tensor_cores(q_dtype, kv_dtype) -> bool:
    """Whether the chunk kernel runs its tensor-core tiles (bf16/f16
    queries over a pool of their own type or int8, split over keys) or its
    FMA body (every other pairing, one pass)."""
    return (q_dtype in (torch.bfloat16, torch.float16)
            and kv_dtype in (q_dtype, torch.int8))


def chunk_split(B: int, Hkv: int, C: int, group: int, n_keys: int,
                n_sm: int, dh: int) -> int:
    """Keys a split of the chunk kernel's tensor-core tiles
    (csrc/chunk_prefill_attention.cu) over a page table of ``n_keys =
    n_pp * page_size`` keys, at head width ``dh``.

    A pure function of the shapes and the card's SM count, never of
    ``start`` or ``n_valid`` (which lie on the device: reading them would
    cost a device-to-host sync a layer). A block takes one split of one
    (sequence, kv head, row tile): rows come 64 a tile (16 when ``C *
    group <= 16``) and keys 32 a stage (64 with 16-row tiles up to head
    width 256; above it two warps share each tile's columns and a stage
    holds 32 keys, since two stages of 64 would not fit a block's shared
    memory at 512). The table is cut into the number of splits that brings
    the blocks nearest to two an SM, and into at least enough that no
    split exceeds four stages (at most 256 keys; the kernel takes up to
    4096); a split is whole stages. ``ceil(n_keys / split)`` splits then
    cover the table."""
    rows = C * group
    bm, sk = (16, 64 if dh <= 256 else 32) if rows <= 16 else (64, 32)
    units = B * Hkv * -(-rows // bm)
    n_keys = max(n_keys, 1)
    n_split = max(1, (2 * n_sm + units // 2) // units,
                  -(-n_keys // (_CHUNK_STEPS * sk)))
    split = -(-n_keys // n_split)
    return -(-split // sk) * sk


def _launch_chunk(name, q, k_pages, v_pages, page_table, start, *, n_valid=None,
                  n_fed=None, scale, k_scale, v_scale, split_kv_heads):
    """Check and launch the chunk kernel (csrc/chunk_prefill_attention.cu)
    for the entry ``name``. start: an int (every sequence's) or a (B,)
    int32 tensor on the card; n_valid, or else n_fed (n_valid = start +
    n_fed): (B,) int32 on the card. The kernel reads them as given, so no
    tensor is built for them here. On the tensor-core tiles with more than
    one split, the partials go to f32 scratch allocated here and a second
    launch combines them; ``split_kv_heads`` (None: the pool's) is the KV-head
    count the split is sized from."""
    B, C, H, dh = q.shape
    vecs = [t for t in (start, n_valid, n_fed) if isinstance(t, torch.Tensor)]
    _check(q, k_pages, v_pages, k_scale, v_scale, (page_table, *vecs),
           q_ndim=4)
    n_pages, ps, Hkv = k_pages.shape[:3]
    if (page_table.dim() != 2 or page_table.shape[0] != B
            or any(t.shape != (B,) for t in vecs)):
        raise ValueError("page_table must be (B, n_pp), start, n_valid and "
                         "n_fed (B,)")
    if q.data_ptr() % 16:
        raise ValueError("q must be 16-byte aligned")
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    n_pp = page_table.shape[1]
    split, n_split, part = 0, 1, None
    if chunk_on_tensor_cores(q.dtype, k_pages.dtype):
        split = chunk_split(B, _split_heads(split_kv_heads, Hkv), C,
                            H // Hkv, n_pp * ps, _sm_count(q.device.index),
                            dh)
        n_split = max(1, -(-(n_pp * ps) // split))
        if n_split > 1:
            # pass 1's partials: acc (B*C*H, n_split, dh), then m and l
            part = torch.empty(B * C * H * n_split * (dh + 2),
                               dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    fn = _fn("chunk_prefill_attention")
    vec_start = isinstance(start, torch.Tensor)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), _ptr(start) if vec_start else None,
            # repro: allow(traced-purity): int(start) runs for a host int only
            0 if vec_start else int(start), _ptr(n_valid), _ptr(n_fed),
            _ptr(k_scale), _ptr(v_scale), _ptr(part), out.data_ptr(), B, C, H,
            Hkv, dh, ps, n_pp, n_pages, split, n_split, _DTYPE_CODE[q.dtype],
            _DTYPE_CODE[k_pages.dtype], float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"{name} launch failed (rc={rc})")
    return out


def _chunk_split_plain(q, k_pages, v_pages, page_table, start, n_valid,
                       split: int, *, scale: float = None, k_scale=None,
                       v_scale=None):
    """Plain mirror of the chunk kernel's split over keys, for the tests
    (the plain version of the function is ``chunk_prefill_attention_plain``).

    Pass 1 gives split s, keys ``[s * split, (s + 1) * split)`` of the
    gathered table, clipped to each query row's frontier ``min(start[b] + c
    + 1, n_valid[b])``, each row's max m, sum l and unnormalised
    accumulator acc, with the kernel's int8 scale folding: the scores are
    the integer dots times ``scale * k_scale[h]`` and acc the integer sums
    times ``v_scale[h]``. A split wholly past a row's frontier has m =
    NEG_INF, l = 0, acc = 0. Pass 2 combines the splits as the dense decode
    does (``_decode_split_plain``). Returns out (B, C, H, dh) in q's dtype
    and the partials (m, l: (B, C, H, n_split); acc: (B, C, H, n_split,
    dh))."""
    B, C, H, dh = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    kd = _gather(k_pages, page_table).float()        # (B, L, Hkv, dh)
    vd = _gather(v_pages, page_table).float()
    L, Hkv = kd.shape[1], kd.shape[2]
    g = H // Hkv
    n_split = max(1, -(-L // split))
    pad = n_split * split - L
    ones = torch.ones(Hkv, device=q.device)
    ksc = (k_scale.float() if k_scale is not None else ones) * scale
    vsc = v_scale.float() if v_scale is not None else ones
    start = _start_vector(start, B, q.device).long()
    hi = torch.minimum(start[:, None] + torch.arange(C, device=q.device) + 1,
                       n_valid.to(q.device).long()[:, None])      # (B, C)
    s = (torch.einsum("bchgd,blhd->bhgcl", q.reshape(B, C, Hkv, g, dh).float(),
                      kd) * ksc[None, :, None, None, None])
    keep = torch.arange(L, device=q.device)[None, None, :] < hi[:, :, None]
    s = torch.where(keep[:, None, None], s, torch.full_like(s, NEG_INF))
    s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF)
    s = s.reshape(B, Hkv, g, C, n_split, split)
    m = s.amax(dim=-1)                                   # (B, Hkv, g, C, n)
    p = torch.where(s <= NEG_INF / 2, torch.zeros_like(s),
                    _exp(s - m[..., None]))
    l = p.sum(dim=-1)
    vd = torch.nn.functional.pad(vd, (0, 0, 0, 0, 0, pad))
    acc = (torch.einsum("bhgcnk,bnkhd->bhgcnd", p,
                        vd.reshape(B, n_split, split, Hkv, dh))
           * vsc[None, :, None, None, None, None])
    w = torch.where(m <= NEG_INF / 2, torch.zeros_like(m),
                    _exp((m - m.amax(dim=-1, keepdim=True))
                         .clamp_max(0.0)))
    out = ((w[..., None] * acc).sum(dim=-2)
           / (w * l).sum(dim=-1).clamp_min(1e-30)[..., None])

    def rows(x):   # (B, Hkv, g, C, ...) -> (B, C, H, ...)
        return x.movedim(3, 1).reshape(B, C, H, *x.shape[4:])
    return rows(out).to(q.dtype), (rows(m), rows(l), rows(acc))


def chunk_prefill_attention_plain(q, k_pages, v_pages, page_table, start,
                                  n_valid, *, scale: float = None,
                                  k_scale=None, v_scale=None):
    """Plain PyTorch version: gather the pages densely; query (b, c) sits at
    absolute position start[b] + c and attends key positions
    < min(start[b] + c + 1, n_valid[b]). q: (B, C, H, dh) -> (B, C, H, dh)."""
    B, C = q.shape[:2]
    start = _start_vector(start, B, q.device)
    hi = torch.minimum(start[:, None] + torch.arange(C, device=q.device) + 1,
                       n_valid.to(q.device)[:, None])          # (B, C)
    return _attend_chunk_plain(q, k_pages, v_pages, page_table, hi,
                               scale=scale, k_scale=k_scale, v_scale=v_scale)


def chunk_prefill_attention(q, k_pages, v_pages, page_table, start, n_valid,
                            *, scale: float = None, k_scale=None,
                            v_scale=None,
                            split_kv_heads: Optional[int] = None):
    """Chunked-prefill attention: a query chunk against the paged pool.

    q: (B, C, H, dh) — one prefill chunk whose queries sit at absolute
    positions [start, start + C); the pool ALREADY holds the chunk's own KV.
    start: int, 0-d or (B,) int32 tensor; n_valid: (B,) int32 total valid
    tokens once the chunk lands (masks the chunk's right-padding). Row
    (c, head) attends key positions < min(start + c + 1, n_valid).
    ``split_kv_heads``: as in ``paged_decode_attention``.
    Returns (B, C, H, dh) in q's dtype."""
    if not _on_cuda(q):
        return chunk_prefill_attention_plain(
            q, k_pages, v_pages, page_table, start, n_valid, scale=scale,
            k_scale=k_scale, v_scale=v_scale)
    if isinstance(start, torch.Tensor):
        start = _start_vector(start, q.shape[0], q.device)
    out = _launch_chunk("chunk_prefill_attention", q, k_pages, v_pages,
                        page_table, start, n_valid=n_valid, scale=scale,
                        k_scale=k_scale, v_scale=v_scale,
                        split_kv_heads=split_kv_heads)
    # a host counter: CUDA-graph capture runs it once, a replay never
    # repro: allow(traced-purity): P1 adds graph replays to the count
    chunk_prefill_attention.launches += 1
    chunk_prefill_attention.launches_by_heads[k_pages.shape[2]] += 1
    return out


chunk_prefill_attention.launches = 0
chunk_prefill_attention.launches_by_heads = collections.Counter()


# --------------------------- speculative verify ------------------------- #

def spec_verify_attention_plain(q, k_pages, v_pages, page_table, seq_lens,
                                n_fed, *, scale: float = None, k_scale=None,
                                v_scale=None):
    """Plain PyTorch version, the reference's XLA route for a per-sequence
    start: gather the pages densely; row j of sequence b sits at position
    ``min(seq_lens[b] + j, seq_lens[b] + n_fed[b] - 1)`` (pad rows clipped
    to the last fed row) and attends key positions <= it.
    q: (B, C, H, dh) -> (B, C, H, dh)."""
    C = q.shape[1]
    seq_lens = seq_lens.to(q.device, torch.int64)
    last = seq_lens + n_fed.to(q.device, torch.int64) - 1
    qpos = torch.minimum(seq_lens[:, None] + torch.arange(C, device=q.device),
                         last[:, None])                       # (B, C)
    return _attend_chunk_plain(q, k_pages, v_pages, page_table, qpos + 1,
                               scale=scale, k_scale=k_scale, v_scale=v_scale)


def spec_verify_attention(q, k_pages, v_pages, page_table, seq_lens, n_fed,
                          *, scale: float = None, k_scale=None,
                          v_scale=None,
                          split_kv_heads: Optional[int] = None):
    """Speculative-verify attention: a window of C queries per sequence
    against the paged pool, per-sequence start, per-row causal frontier.

    q: (B, C, H, dh) — the window ``[t_last, d_1 .. d_{C-1}]`` at absolute
    positions ``seq_lens[b] + j``; the pool ALREADY holds the window's KV.
    seq_lens: (B,) int32 tokens landed before the window; n_fed: (B,) int32
    real window tokens (1 <= n_fed <= C; shorter drafts right-pad). Row j
    attends key positions ``<= seq_lens[b] + min(j, n_fed[b] - 1)``.

    On the card this is the chunk kernel (``csrc/chunk_prefill_attention
    .cu``) with ``start = seq_lens`` and ``n_valid = seq_lens + n_fed``,
    which the kernel adds as it reads them; ``split_kv_heads``: as in
    ``paged_decode_attention``. Returns (B, C, H, dh) in q's dtype."""
    if not _on_cuda(q):
        return spec_verify_attention_plain(
            q, k_pages, v_pages, page_table, seq_lens, n_fed, scale=scale,
            k_scale=k_scale, v_scale=v_scale)
    out = _launch_chunk("spec_verify_attention", q, k_pages, v_pages,
                        page_table, seq_lens, n_fed=n_fed, scale=scale,
                        k_scale=k_scale, v_scale=v_scale,
                        split_kv_heads=split_kv_heads)
    # a host counter: CUDA-graph capture runs it once, a replay never
    # repro: allow(traced-purity): P1 adds graph replays to the count
    spec_verify_attention.launches += 1
    spec_verify_attention.launches_by_heads[k_pages.shape[2]] += 1
    return out


spec_verify_attention.launches = 0
spec_verify_attention.launches_by_heads = collections.Counter()


# ------------------------------ dense decode ---------------------------- #

def decode_attention_plain(q, k_cache, v_cache, kv_valid, *,
                           scale: float = None, k_scale=None, v_scale=None):
    """Plain PyTorch version: K/V to f32 (times their scales when int8),
    mask positions >= kv_valid[b], softmax in f32. q: (B, H, dh) ->
    (B, H, dh)."""
    return _decode_plain(q, _dequant_dense(k_cache, k_scale),
                         _dequant_dense(v_cache, v_scale), kv_valid,
                         scale=scale)


_SPLIT_ALIGN = 16   # keys a split is a multiple of
_SPLIT_MAX = 128    # keys a split at most: pass 1 walks a split serially


def decode_split(B: int, Hkv: int, L: int, group: int, n_sm: int) -> int:
    """Keys a split of the split-K dense decode (csrc/decode_attention.cu).

    A pure function of the shapes and the card's SM count, never of
    ``kv_valid`` (which lies on the device: reading it would cost a
    device-to-host sync a layer). A pass-1 block takes one split of one
    (sequence, kv head) for the GQA group, 16 rows at a time (FmaRows: 8
    at head widths 256 and 384, 4 at 512, where the rule stays the same:
    it sizes the grid, and a block's passes over its rows read the split's
    keys from L2), so the card holds ``B * Hkv * ceil(group / 16)`` units
    of work a split.
    The cache is cut into the number of splits that brings that nearest to
    two an SM, and into at least enough that no split exceeds 128 keys, in
    multiples of 16 keys. ``ceil(L / split)`` splits then cover ``L``."""
    units = B * Hkv * -(-group // 16)
    n_split = max(1, (2 * n_sm + units // 2) // units,
                  -(-L // _SPLIT_MAX))
    split = -(-max(L, 1) // n_split)
    return -(-split // _SPLIT_ALIGN) * _SPLIT_ALIGN


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _decode_split_plain(q, k_cache, v_cache, kv_valid, split: int, *,
                        scale: float = None, k_scale=None, v_scale=None):
    """Plain mirror of the split-K dense decode's two passes, for the tests
    (the plain version of the function is ``decode_attention_plain``).

    Pass 1 gives split s, keys ``[s * split, (s + 1) * split)`` clipped to
    ``min(kv_valid[b], L)``, each query row's max m, sum l and unnormalised
    accumulator acc; a split wholly past the valid length has m = NEG_INF,
    l = 0, acc = 0. Pass 2 combines the splits: ``M = max m``,
    ``w = exp(min(m - M, 0))`` (0 where m <= NEG_INF / 2),
    ``out = sum w acc / max(sum w l, 1e-30)``. Returns out (B, H, dh) in
    q's dtype and the partials (m, l: (B, H, n_split); acc: (B, H,
    n_split, dh))."""
    B, H, dh = q.shape
    L, Hkv = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    g = H // Hkv
    n_split = max(1, -(-L // split))
    pad = n_split * split - L
    kd = _dequant_dense(k_cache, k_scale)
    vd = torch.nn.functional.pad(_dequant_dense(v_cache, v_scale),
                                 (0, 0, 0, 0, 0, pad))
    s = torch.einsum("bhgd,blhd->bhgl", q.reshape(B, Hkv, g, dh).float(),
                     kd) * scale
    keep = (torch.arange(L, device=q.device)[None, :]
            < kv_valid.to(q.device)[:, None])                   # (B, L)
    s = torch.where(keep[:, None, None, :], s, torch.full_like(s, NEG_INF))
    s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF)
    s = s.reshape(B, Hkv, g, n_split, split)
    m = s.amax(dim=-1)                                      # (B, Hkv, g, n)
    p = torch.where(s <= NEG_INF / 2, torch.zeros_like(s),
                    _exp(s - m[..., None]))
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgnk,bnkhd->bhgnd", p,
                       vd.reshape(B, n_split, split, Hkv, dh))
    w = torch.where(m <= NEG_INF / 2, torch.zeros_like(m),
                    _exp((m - m.amax(dim=-1, keepdim=True))
                         .clamp_max(0.0)))
    out = ((w[..., None] * acc).sum(dim=-2)
           / (w * l).sum(dim=-1).clamp_min(1e-30)[..., None])
    return (out.reshape(B, H, dh).to(q.dtype),
            (m.reshape(B, H, n_split), l.reshape(B, H, n_split),
             acc.reshape(B, H, n_split, dh)))


def decode_attention(q, k_cache, v_cache, kv_valid, *, scale: float = None,
                     k_scale=None, v_scale=None):
    """Decode attention over a dense KV cache.

    q: (B, H, dh), dh 64, 128, 256, 384 or 512; k/v_cache: (B, L, Hkv, dh) (int8
    when scales are given, else any of f32/bf16/f16), any L; kv_valid:
    (B,) int32 valid positions
    per sequence (positions >= kv_valid[b] are masked and, on the card,
    never read); k/v_scale: (Hkv,) f32. The GQA group of H/Hkv consecutive
    query heads reads one kv head. Returns (B, H, dh) in q's dtype.

    On the card the cache is cut into splits of ``decode_split(...)`` keys:
    pass 1 writes each split's partials into f32 scratch allocated here,
    pass 2 combines them in split order (bitwise repeatable)."""
    if not _on_cuda(q):
        return decode_attention_plain(q, k_cache, v_cache, kv_valid,
                                      scale=scale, k_scale=k_scale,
                                      v_scale=v_scale)
    _check(q, k_cache, v_cache, k_scale, v_scale, (kv_valid,), q_ndim=3)
    B, H, dh = q.shape
    L, Hkv = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != B or kv_valid.shape != (B,):
        raise ValueError(f"caches must be (B={B}, L, Hkv, dh) and kv_valid "
                         f"({B},), got {tuple(k_cache.shape)} and "
                         f"{tuple(kv_valid.shape)}")
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    split = decode_split(B, Hkv, L, H // Hkv, _sm_count(q.device.index))
    n_split = max(1, -(-L // split))
    # pass 1's partials: acc (B, H, n_split, dh), then m and l (B, H, n_split)
    part = torch.empty(B * H * n_split * (dh + 2), dtype=torch.float32,
                       device=q.device)
    out = torch.empty_like(q)
    rc = _fn("decode_attention")(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        kv_valid.data_ptr(), _ptr(k_scale), _ptr(v_scale), part.data_ptr(),
        out.data_ptr(), B, H, Hkv, dh, L, split, n_split,
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_cache.dtype], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"decode_attention launch failed (rc={rc})")
    # a host counter: CUDA-graph capture runs it once, a replay never
    # repro: allow(traced-purity): P1 adds graph replays to the count
    decode_attention.launches += 1
    decode_attention.launches_by_heads[Hkv] += 1
    return out


decode_attention.launches = 0
decode_attention.launches_by_heads = collections.Counter()
