"""Head-sharded execution of the paged attention kernels over
``torch.distributed`` (the reference is ``repro/kernels/sharded.py``,
DESIGN.md SS16).

N ranks, one process each, serve as one: each holds ``Hkv/N`` KV heads of
every page of the paged pool (rank r the r-th contiguous block) and runs
the UNCHANGED kernels of ``kernels.decode_attention`` over its own head
slice. The kernels iterate (sequence, kv head, page) and only dereference
the page table, which is replicated, so a shard needs no new index math.
Query heads partition in the same contiguous blocks (``H/N = (Hkv/N) *
group``, so the GQA groups survive slicing); the page table, lengths and
window starts are replicated: every rank attends over the SAME pages, only
the head slice differs.

Each rank's head outputs are all-gathered back into full head order before
the replicated output projection. Per-head attention is arithmetically
independent, the gather only reorders, and the kernels' splits are sized
from the unsharded head count (``split_kv_heads``), so the result is
bitwise identical to the unsharded one: the property the engine's token
identity leans on. (Sharding the qkv/wo products instead would reorder
their sums and break bitwise equality; they stay replicated on purpose, as
the weights do.)

The reference runs one controller over a JAX mesh; here every rank runs
the same host code (scheduler, KV manager, trace, virtual clock) on
replicated tokens, so the ranks' host decisions agree. The one input that
differs between ranks is measured wall time, which ``agree_max`` makes
common.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

# the reference's name for its mesh axis of KV heads, kept so the two
# modules name the same things; the port's group has no named axes
AXIS = "model"


@dataclass(frozen=True, eq=False)
class ShardGroup:
    """The port's ``kv_shard_mesh``: the process group whose ranks each hold
    one head slice of the pool, this process's rank in it, its size, the
    rank's device, and a gloo group for host values (``None``: the process
    group is gloo already)."""
    pg: object
    rank: int
    size: int
    device: torch.device
    host: object = None

    @classmethod
    def from_world(cls, shards: int, device) -> "ShardGroup":
        """The default process group as a group of ``shards`` ranks; raises
        ValueError when there is none or its size differs. ``device``: a
        CUDA device without an index becomes ``cuda:(rank % cards)``, and a
        CUDA device is made this process's current one: nccl's collectives,
        what names no index (``"cuda"``) and the kernels, which the CUDA
        runtime launches on the current device, then run on the rank's
        card."""
        world = (dist.get_world_size()
                 if dist.is_available() and dist.is_initialized() else 0)
        if world != shards:
            have = (f"the process group has {world} ranks" if world else
                    "no torch.distributed process group is initialized")
            raise ValueError(
                f"shards={shards} needs a torch.distributed process group of "
                f"{shards} ranks, one process a shard, but {have}; launch "
                f"them with repro_torch.launch.ranks.run_ranks (or the serve "
                f"CLI's --shards {shards})")
        rank = dist.get_rank()
        device = torch.device(device)
        if (device.type == "cuda" and device.index is None
                and torch.cuda.is_available()):
            device = torch.device("cuda", rank % torch.cuda.device_count())
        if device.type == "cuda":
            torch.cuda.set_device(device)
        host = (None if dist.get_backend() == "gloo"
                else dist.new_group(backend="gloo"))
        return cls(dist.group.WORLD, rank, shards, device, host)


def head_shards(group, n_kv_heads: int) -> int:
    """Usable shard count, as the reference defines it: the group's size
    when it is > 1 and divides the KV-head count, else 0 (no sharding).
    ``ServeEngine`` refuses the other counts before it builds a group, so
    the port's model code keys on ``RuntimeOptions.kv_shard`` alone."""
    if group is None:
        return 0
    n = group.size
    return n if n > 1 and n_kv_heads % n == 0 else 0


def head_slice(group, n_heads: int) -> slice:
    """This rank's contiguous block of ``n_heads`` heads."""
    n = n_heads // group.size
    return slice(group.rank * n, (group.rank + 1) * n)


def sharded_attend(group, attend, q, k_pages, v_pages, k_scale, v_scale,
                   extras, *, q_head_axis: int):
    """Run ``attend``, any per-head paged attention body, head-sharded.

    q is replicated (all heads) and is cut to this rank's block on
    ``q_head_axis``; k_pages/v_pages (n_pages, page_size, Hkv/N, dh) and
    the (Hkv/N,) scales (or None) are this rank's slice already, as the
    sharded pool holds them; ``extras`` (page table, lengths, window
    starts) are replicated. ``attend(q, kp, vp, ksc, vsc, *extras)`` runs
    on the local slice and returns a tensor of q's rank with
    ``q_head_axis`` as its head axis; the ranks' slices are all-gathered
    and tiled back into full head order, replicated on every rank."""
    q_l = q[(slice(None),) * q_head_axis
            + (head_slice(group, q.shape[q_head_axis]),)].contiguous()
    out = attend(q_l, k_pages, v_pages, k_scale, v_scale, *extras)
    parts = [torch.empty_like(out) for _ in range(group.size)]
    # gloo (ranks sharing one card) stages a CUDA all_gather through the
    # host; nccl's is a device collective, which a CUDA graph can capture
    # repro: allow(traced-purity): a host hop under gloo only
    dist.all_gather(parts, out.contiguous(), group=group.pg)
    return torch.cat(parts, dim=q_head_axis)


def agree_max(group, x: float) -> float:
    """The largest of the ranks' host floats ``x``: with ``x`` a measured
    wall time, every rank then charges the slowest rank's time to its
    virtual clock (the reference's sharded program ends when its slowest
    shard does), so the ranks' schedules, and hence their collectives,
    stay paired. A host-to-host exchange over gloo, not a device sync."""
    t = torch.tensor([x], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group.host)
    return float(t[0])


@dataclass(frozen=True)
class ModelAxis:
    """This process's place on the ranks that split one tensor dim (the
    reference's mesh axis "model" under ``shard_map``): its index, the
    number of ranks, and ``reduce(t, op)``, an all-reduce ("sum" or "max")
    over them as a functional collective (``_c10d_functional``)."""
    index: int
    size: int
    group: object

    def reduce(self, t, op: str):
        import torch.distributed._functional_collectives as funcol
        if self.size == 1:
            return t
        return funcol.wait_tensor(funcol.all_reduce(t, op, self.group))


def model_axis(group) -> ModelAxis:
    """``ModelAxis`` of a ``ShardGroup`` (real ranks, one process each) or
    of a ``DeviceMesh``'s "model" dim (the dry run, where a DTensor body
    runs under ``local_map`` on rank 0's shards)."""
    if isinstance(group, ShardGroup):
        return ModelAxis(group.rank, group.size, group.pg)
    names = group.mesh_dim_names or ()
    if AXIS not in names:
        return ModelAxis(0, 1, None)
    dim = names.index(AXIS)
    return ModelAxis(group.get_local_rank(AXIS), group.size(dim),
                     (group, dim))
