"""What each rank of ``test_torch_cost.py``'s collective test runs: the
ranks are spawned (``repro_torch.launch.ranks.run_ranks``), so their work
lives in this module, which imports no JAX, and reaches them by import
path."""
import torch
import torch.distributed as dist

import repro_torch.models as tm
from repro_torch.core.cost_analysis import analyze
from repro_torch.kernels.sharded import ShardGroup


def sharded_decode_costs(rank, cfg, B, page_size, n_pp):
    """The cost extractor over one paged decode step on this rank's head
    shard (f32, seeded weights, every slot at 3 cached tokens), and over
    the same step unsharded, and over an all-reduce of 8 f32 values.
    Returns (sharded collective bytes, sharded collective kinds,
    unsharded collective bytes, the all-reduce's collective kinds)."""
    group = ShardGroup.from_world(2, "cpu")
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), "float32",
                            "cpu")
    pt = torch.arange(1, B * n_pp + 1, dtype=torch.int32).reshape(B, n_pp)
    seq = torch.full((B,), 3, dtype=torch.int32)
    tok = torch.ones(B, dtype=torch.int32)
    out = []
    for shard in (group, None):
        opts = tm.RuntimeOptions(dtype="float32", kv_shard=shard)
        cache = tm.init_paged_cache(cfg, 1 + B * n_pp, page_size, opts, "cpu")
        out.append(analyze(tm.decode_step_paged, cfg, params, tok, seq, pt,
                           cache, opts))
    reduced = analyze(dist.all_reduce, torch.ones(8))
    return (out[0].collective_bytes, out[0].collective_counts,
            out[1].collective_bytes, reduced.collective_counts)
