"""What each rank of the head-sharded CPU tests (``test_torch_shard.py``)
runs: the ranks are spawned (``repro_torch.launch.ranks.run_ranks``), so
their work lives in this module, which imports no JAX, and reaches them by
import path. Every function returns numpy arrays and plain values."""
import dataclasses

import numpy as np
import torch

import repro_torch.models as tm
from repro_torch.kernels.sharded import ShardGroup
from repro_torch.serving import ServeEngine

# the reference's engine identity settings (tests/test_shard_serve.py)
ENGINE_KW = dict(max_len=40, scheduler="continuous", page_size=8,
                 max_batch=3)
COUNTERS = ("host_syncs", "decode_steps", "decode_compiles",
            "prefill_tokens_computed", "new_tokens", "peak_pages_used",
            "preemptions", "draft_proposed", "draft_accepted")


def _kernel_path(cfg, params, group):
    """The reference's kernel oracle (``test_sharded_kernels_bitwise_
    match_single_device``): a decode loop, a prefill chunk and a fused
    K-step block over the paged pool, unsharded and on this rank's head
    shard, f32 and int8. Returns {case: (unsharded, sharded)}."""
    B, S, K, ps = 2, 8, 4, 4
    rng = np.random.default_rng(3)
    true_len = np.asarray([8, 6], np.int32)
    toks = np.zeros((B, S), np.int32)
    for b in range(B):
        toks[b, :true_len[b]] = rng.integers(1, cfg.vocab, size=true_len[b])
    npp = (S + K + ps - 1) // ps
    n_pages = B * npp + 1
    pt = torch.arange(1, B * npp + 1, dtype=torch.int32).reshape(B, npp)
    toks, lens0 = torch.from_numpy(toks), torch.from_numpy(true_len)

    def argmax(logits):
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def prefilled(opts, cal):
        cache = tm.init_paged_cache(cfg, n_pages, ps, opts, "cpu")
        logits, cache = tm.prefill_paged_chunk(cfg, params, toks, cache, pt,
                                               0, lens0, opts, calibrate=cal)
        return argmax(logits[torch.arange(B), lens0.long() - 1]), cache, logits

    def dec_loop(opts, cal):
        tok, cache, _ = prefilled(opts, cal)
        lens, cols = lens0, [tok]
        for _ in range(K):
            logits, cache = tm.decode_step_paged(cfg, params, tok, lens, pt,
                                                 cache, opts)
            tok = argmax(logits)
            cols.append(tok)
            lens = lens + 1
        return torch.stack(cols, 1), logits

    def chunk(opts, cal):
        return (prefilled(opts, cal)[2],)

    def fused(opts, cal):
        tok, cache, _ = prefilled(opts, cal)
        return (tm.decode_steps_paged(cfg, params, tok, lens0, pt, cache, K,
                                      opts)[0],)

    out = {}
    for cache_dtype in ("", "int8"):
        opts0 = tm.RuntimeOptions(dtype="float32", cache_dtype=cache_dtype)
        opts1 = dataclasses.replace(opts0, kv_shard=group)
        cal = cache_dtype == "int8"
        for fn in (dec_loop, chunk, fused):
            base, shard = fn(opts0, cal), fn(opts1, cal)
            for i, (a, b) in enumerate(zip(base, shard)):
                out[f"{fn.__name__}{i}{cache_dtype}"] = (a.numpy(), b.numpy())
        out[f"pool_bytes{cache_dtype}"] = tuple(
            sum(t.numel() * t.element_size()
                for t in tm.init_paged_cache(cfg, n_pages, ps, o,
                                             "cpu")["stack"].values())
            for o in (opts0, opts1))
    return out


def _serve(cfg, params, shards, reqs, new, kw):
    eng = ServeEngine(cfg, params, tm.RuntimeOptions(dtype="float32"),
                      device="cpu", shards=shards, **kw)
    outs = eng.serve([r[:] for r in reqs], new)
    return dict(outs=outs, ok=eng.trace_report["ok"],
                device=str(eng.device),
                pages_left=eng.kv_manager.n_used,
                peak_fast_pages=eng.stats.peak_fast_pages,
                counters={c: getattr(eng.stats, c) for c in COUNTERS})


def rank_main(rank, cfg, np_params, shards, engine_runs, budget):
    """One rank's share of the tests: the kernel oracle, then each engine
    run ``(label, reqs, new, kwargs)`` of ``engine_runs`` at ``shards``
    (``ENGINE_KW`` under kwargs), then, where ``budget`` is ``(hierarchy,
    request)``, the per-device budget run."""
    torch.set_num_threads(1)
    params = tm.params_from_numpy(np_params, device="cpu")
    group = ShardGroup.from_world(shards, "cpu")
    res = dict(rank=group.rank, kernel_path=_kernel_path(cfg, params, group))
    for label, reqs, new, kw in engine_runs:
        res[label] = _serve(cfg, params, shards, reqs, new,
                            dict(ENGINE_KW, **kw))
    if budget is not None:
        hier, req = budget
        res["budget"] = _serve(cfg, params, shards, [req], 8,
                               dict(ENGINE_KW, max_len=32, max_batch=2,
                                    hierarchy=hier))
    return res


def rank_devices(rank, card_counts):
    """``ShardGroup.from_world(world, "cuda")`` on a host that claims each
    of ``card_counts`` cards (torch.cuda's answers faked in this spawned
    rank): the group's device and the devices made current, a card count
    each, and a return value larger than a pipe's buffer."""
    import torch.distributed as dist
    made_current = []
    torch.cuda.is_available = lambda: True
    torch.cuda.set_device = lambda d: made_current.append(str(d))
    out = {}
    for cards in card_counts:
        torch.cuda.device_count = lambda cards=cards: cards
        group = ShardGroup.from_world(dist.get_world_size(), "cuda")
        out[cards] = (str(group.device), made_current[:])
        made_current.clear()
    return out, np.arange(100_000)


def rank_fails(rank):
    """Rank 1 raises while rank 0 waits for it in a collective."""
    import torch.distributed as dist
    if rank == 1:
        raise KeyError("rank 1 fails")
    dist.barrier()
