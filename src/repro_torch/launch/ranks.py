"""Launch the ranks of a head-sharded run (``ServeEngine(shards=N)``): N
processes, one a shard, each a rank of one ``torch.distributed`` process
group.

    from repro_torch.launch.ranks import backend_for, run_ranks
    outs = run_ranks(serve_one, 2, (cfg, reqs), backend=backend_for(2, "cuda"),
                     timeout=600)

``serve_one(rank, cfg, reqs)`` runs in every rank (a module-level function:
the ranks are spawned, so it travels by import path) and its return values
come back in rank order. The ranks meet through a ``FileStore`` in a fresh
temporary directory, so no port is opened. A rank that raises fails the
whole run: ``torch.multiprocessing``'s join ends the other ranks, which may
be blocked in a collective waiting for it, and the parent re-raises the
rank's exception; a rank that dies without a word, or a run past
``timeout``, raises too.
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time

import torch
import torch.multiprocessing as mp

# after a rank fails, how long the others get to fail in turn and report
# (within moments: its teardown ends their collectives) before they are
# killed
_GRACE_S = 2.0


def backend_for(n_ranks: int, device) -> str:
    """'nccl' when every rank can have a card of its own, else 'gloo': CPU
    ranks, and ranks that share one card (NCCL refuses two ranks on one
    device; gloo's all-gather takes CUDA tensors)."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= n_ranks:
        return "nccl"
    return "gloo"


def _rank_main(rank, n, store, backend, timeout, fn, args, results):
    import torch.distributed as dist
    # the ranks share the host's cores: each takes its share of threads
    # (more would spin against each other in every collective)
    torch.set_num_threads(max(1, torch.get_num_threads() // n))
    try:
        dist.init_process_group(
            backend, store=dist.FileStore(store, n), rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=timeout))
        results.put((rank, True, fn(rank, *args)))
    except Exception as e:
        # the exception object travels too, so the parent raises its type
        # (the join reports only its traceback's text), stamped before this
        # rank's teardown fails the others in turn: the parent raises the
        # earliest failure, the cause
        try:
            pickle.dumps(e)
        except Exception:
            e = RuntimeError(f"{type(e).__name__}: {e}")
        results.put((rank, False, (time.time(), e)))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, n: int, args=(), *, backend: str = "gloo",
              timeout: float = 600.0):
    """Run ``fn(rank, *args)`` in ``n`` spawned ranks of a process group
    (``backend``, collectives timing out after ``timeout`` s) and return
    their results in rank order. Re-raises the earliest rank failure
    (with the traceback of the rank the join saw fail as a note), raises
    ``ProcessExitedException`` for a rank that died without one and
    TimeoutError past ``timeout``; every rank has ended when it returns."""
    results = mp.get_context("spawn").SimpleQueue()
    got, failed = {}, {}

    def drain():
        # a rank's put blocks while the pipe is full, so read as they come
        while not results.empty():
            rank, ok, val = results.get()
            (got if ok else failed)[rank] = val

    with tempfile.TemporaryDirectory() as tmp:
        ranks = mp.start_processes(
            _rank_main, (n, os.path.join(tmp, "store"), backend, timeout, fn,
                         args, results),
            nprocs=n, join=False, daemon=True, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ranks.join(timeout=0.5, grace_period=_GRACE_S):
                drain()
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n - len(got)} of {n} ranks still "
                                       f"running after {timeout}s")
        except mp.ProcessRaisedException as e:
            # the join gave the others the grace to fail and report; the
            # rank it saw fail first may be one that failed in turn
            drain()
            if not failed:
                raise
            rank, (_, exc) = min(failed.items(), key=lambda kv: kv[1][0])
            exc.add_note(f"raised in rank {rank} of {n}; the join saw "
                         f"rank {e.error_index} fail:{e}")
            raise exc from None
        finally:
            for p in ranks.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        drain()
    return [got[r] for r in range(n)]
