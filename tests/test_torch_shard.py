"""Head-sharded continuous serving of the port (``ServeEngine(shards=N)``,
``kernels.sharded``) on the CPU: N gloo ranks spawned from the test, each
holding Hkv/N KV heads of every page, held against the unsharded port and
the reference's JAX engine at shards=1. Each test mirrors one of the
reference's ``tests/test_shard_serve.py``.

The ranks meet through a FileStore in a temporary directory (no ports),
run on one thread each, and time out: a rank that raises fails the run
(``launch.ranks.run_ranks``) instead of leaving the others blocked in a
collective. The ranks' work is in ``torch_shard_ranks.py``."""

import multiprocessing as mp
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.reduce import reduced
from repro.models import RuntimeOptions as JaxOptions
from repro.models import lm as jlm
from repro.serving import ServeEngine as JaxEngine
import repro_torch.models as tm
from repro_torch.configs import get_config as tget
from repro_torch.configs.reduce import reduced as treduced
from repro_torch.core import hbs, lpddr6, npu_hierarchy
from repro_torch.kernels import sharded as ksh
from repro_torch.launch import serve as tserve
from repro_torch.launch.ranks import run_ranks
from repro_torch.serving import ServeEngine
from repro_torch.serving.kv_manager import page_bytes

import torch_shard_ranks as ranks

torch.set_num_threads(2)

TIMEOUT_S = 120.0          # a group's collectives and whole run
NEW = 8


def _requests(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(1, vocab, size=n).tolist() for n in (20, 9, 14, 6)]


def _budget(tcfg):
    """The reference's per-device budget: a fast tier of 1.5 native f32
    pages and an HBS tier of 2.5, and one 20-token request (4 pages)."""
    pb = page_bytes(tcfg, 8, 4)
    hier = npu_hierarchy(lpddr6(capacity_gb=1.5 * pb / 1e9),
                         hbs(1e3, latency_us=0.0, capacity_gb=2.5 * pb / 1e9))
    req = np.random.default_rng(7).integers(1, tcfg.vocab, size=20).tolist()
    return hier, req


# (label, kwargs) of the engine runs: native and int8, overlapped and
# serialized; n-gram speculation at two shards
RUNS = [(f"{pol}-{'overlap' if ov else 'serial'}",
         dict(kv_policy=pol, overlap=ov))
        for pol in ("native", "int8") for ov in (True, False)]
SPEC = ("ngram-serial", dict(spec_mode="ngram", spec_k=4, overlap=False))


@pytest.fixture(scope="module")
def models():
    cfg = reduced(get_config("llama3.2-1b"), d_model=64, n_layers=2,
                  vocab=128)
    tcfg = treduced(tget("llama3.2-1b"), d_model=64, n_layers=2, vocab=128)
    assert cfg.n_kv_heads == tcfg.n_kv_heads == 4   # divisible by 1, 2, 4
    jp = jlm.init_params(cfg, jax.random.PRNGKey(0),
                         JaxOptions(dtype="float32"))
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    return cfg, tcfg, jp, np_params, tm.params_from_numpy(np_params,
                                                          device="cpu")


@pytest.fixture(scope="module")
def reference(models):
    """The JAX engine at shards=1, serialized streams (its counters are
    then deterministic): outputs and counters a run."""
    cfg, _, jp, _, _ = models
    reqs = _requests(cfg.vocab)
    runs = {}
    for label, kw in RUNS + [SPEC]:
        if kw["overlap"]:
            continue
        eng = JaxEngine(cfg, jp, JaxOptions(dtype="float32"),
                        **ranks.ENGINE_KW, **kw)
        outs = eng.serve([r[:] for r in reqs], NEW)
        runs[label] = (outs, {c: getattr(eng.stats, c)
                              for c in ranks.COUNTERS})
    return runs


@pytest.fixture(scope="module")
def sharded(models):
    """Each shard count's ranks, spawned once: their kernel-path oracles,
    engine runs and (N=4) the per-device budget run; shards=1 in this
    process."""
    _, tcfg, _, np_params, tp = models
    reqs = _requests(tcfg.vocab)
    out = {1: [{label: ranks._serve(tcfg, tp, 1, reqs, NEW,
                                    dict(ranks.ENGINE_KW, **kw))
                for label, kw in RUNS}]}
    for n in (2, 4):
        runs = [(label, reqs, NEW, kw)
                for label, kw in RUNS + ([SPEC] if n == 2 else [])]
        out[n] = run_ranks(ranks.rank_main, n,
                           (tcfg, np_params, n, runs,
                            _budget(tcfg) if n == 4 else None),
                           timeout=TIMEOUT_S)
    return out


# --------------------------- kernel oracles ---------------------------- #

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("cache_dtype", ["", "int8"])
def test_sharded_kernels_bitwise_match_single_device(sharded, n,
                                                     cache_dtype):
    """Head-sharding is a layout change, not a numerics change: a decode
    loop's tokens and last logits, a prefill chunk's logits and a fused
    K-step block's tokens are BITWISE those of the unsharded pool on
    every rank, and a rank's pool holds 1/N of its bytes."""
    for r, res in enumerate(sharded[n]):
        kp = res["kernel_path"]
        assert res["rank"] == r
        for case in ("dec_loop0", "dec_loop1", "chunk0", "fused0"):
            base, shard = kp[case + cache_dtype]
            assert base.dtype == shard.dtype and np.array_equal(base, shard), \
                (n, r, case)
        whole, local = kp["pool_bytes" + cache_dtype]
        assert local * n == whole


# ----------------------- engine token identity ------------------------- #

@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("label", [label for label, _ in RUNS])
def test_engine_token_identity_across_shard_counts(models, reference,
                                                   sharded, n, label):
    """serve() at every shard count, native and int8, streams overlapped
    or serialized, is token-identical to the JAX engine at shards=1 on
    every rank; serialized, its host syncs, decode steps and compiles
    equal the reference's too (overlapped, a block's make-up follows
    measured wall times, which differ between the packages, so counters
    are compared between ranks only)."""
    want_outs, want_counts = reference[label.replace("overlap", "serial")]
    got = [res[label] for res in sharded[n]]
    for r, g in enumerate(got):
        assert g["outs"] == want_outs, (n, label, r)
        assert g["ok"] and g["pages_left"] == 0
        assert g["counters"] == got[0]["counters"]
        assert g["device"] == "cpu"
    if label.endswith("serial"):
        assert got[0]["counters"] == want_counts, (n, label)


def test_engine_ngram_spec_at_two_shards(reference, sharded):
    """n-gram speculation at two shards: tokens and counters (proposals
    and acceptances included) equal the JAX engine's at shards=1."""
    want_outs, want_counts = reference[SPEC[0]]
    for res in sharded[2]:
        g = res[SPEC[0]]
        assert g["outs"] == want_outs and g["ok"]
        assert g["counters"] == want_counts
    assert want_counts["draft_proposed"] > 0


# ----------------------- constructor validation ------------------------ #

def test_shard_constructor_validation(models):
    """The reference's checks, in its order and with its messages; a
    sharded engine without a process group of its size names
    torch.distributed."""
    _, tcfg, _, _, tp = models
    kw = dict(max_len=32, device="cpu")
    with pytest.raises(ValueError, match="shards"):
        ServeEngine(tcfg, tp, scheduler="continuous", shards=0, **kw)
    with pytest.raises(ValueError, match="n_kv_heads"):
        ServeEngine(tcfg, tp, scheduler="continuous", shards=3, **kw)
    with pytest.raises(ValueError, match="continuous"):
        ServeEngine(tcfg, tp, scheduler="static", shards=2, **kw)
    with pytest.raises(ValueError, match="torch.distributed process group"):
        ServeEngine(tcfg, tp, scheduler="continuous", shards=2, **kw)


def test_head_shards_counts_only_dividing_groups():
    """The reference's usable shard count: the group's size when it is > 1
    and divides the KV-head count, else 0."""
    class Group:
        def __init__(self, size):
            self.size = size
    assert ksh.head_shards(None, 4) == 0
    assert [ksh.head_shards(Group(n), 4) for n in (1, 2, 3, 4, 8)] == \
        [0, 2, 0, 4, 0]
    assert ksh.AXIS == "model"


# --------------------------- rank launching ---------------------------- #

def test_rank_device_is_made_current():
    """A CUDA rank without a device index takes cuda:(rank % cards) and
    makes it current (what names no index, nccl's collectives and the
    kernels' launches then use the rank's card), whether ranks have a card
    each or share one; results larger than a pipe's buffer come back."""
    outs = run_ranks(ranks.rank_devices, 2, ((2, 1),), timeout=TIMEOUT_S)
    for r, (devices, big) in enumerate(outs):
        assert devices == {2: (f"cuda:{r}", [f"cuda:{r}"]),
                           1: ("cuda:0", ["cuda:0"])}
        assert np.array_equal(big, np.arange(100_000))


def test_run_ranks_reraises_a_failing_rank_without_hanging():
    """A rank that raises while another waits for it in a collective fails
    the run promptly, with the rank's exception type, and leaves no rank
    running."""
    t0 = time.monotonic()
    with pytest.raises(KeyError, match="rank 1 fails"):
        run_ranks(ranks.rank_fails, 2, timeout=TIMEOUT_S)
    assert time.monotonic() - t0 < TIMEOUT_S / 4
    assert not mp.active_children()


# ------------------------ per-device tier budget ----------------------- #

def test_per_device_budget_admits_what_one_device_cannot(models, sharded):
    """The paper's memory constraint is per chip: each of N shards holds
    1/N of every page, so the same DDR+HBS hierarchy admits N× the pages.
    A request the single-device pool must reject outright runs (token-
    identically) on four shards."""
    _, tcfg, _, _, tp = models
    hier, req = _budget(tcfg)
    kw = dict(ranks.ENGINE_KW, max_len=32, max_batch=2)
    with pytest.raises(ValueError, match="across all"):
        ServeEngine(tcfg, tp, tm.RuntimeOptions(dtype="float32"),
                    device="cpu", hierarchy=hier, **kw).serve([req[:]], 8)
    want = ranks._serve(tcfg, tp, 1, [req], 8, kw)["outs"]
    for res in sharded[4]:
        assert res["budget"]["outs"] == want
        assert res["budget"]["peak_fast_pages"] <= 6    # a device's budget


# ------------------------------- the CLI ------------------------------- #

def test_serve_cli_shards_end_to_end(capfd):
    """``--shards 2`` spawns its two ranks, serves, and rank 0 reports the
    rank-to-device and backend map and the same first output as one
    device."""
    argv = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
            "--scheduler", "continuous", "--concurrency", "3",
            "--prompt-len", "16", "--new-tokens", "6"]
    tserve.main(argv)
    one = capfd.readouterr().out
    tserve.main(argv + ["--shards", "2"])
    two = capfd.readouterr().out
    assert "[serve] shards=2 backend=gloo ranks: 0->cpu 1->cpu" in two
    assert "shards=2 overlap=True" in two
    first = [ln for ln in one.splitlines() if "first output" in ln]
    assert first and first == [ln for ln in two.splitlines()
                               if "first output" in ln]
