"""The port's mixture-of-experts FFN (repro_torch.models.moe) and the two
engines serving an MoE model, against the reference on the CPU.

* ``moe_ffn`` on reduced arctic-480b (dense residual) and on a reduced
  deepseek-v2 ``MoEConfig`` (shared experts; the FFN needs no MLA), with
  the reference's weights carried across by ``params_from_numpy``: the
  same expert ids and kept capacity slots, outputs within 1e-5, aux
  losses within 1e-6, at capacity factors that drop (1.25) and do not
  (8.0); the ragged path against the reference's; capacity == ragged
  when nothing drops; a contested slot goes to the lower replica index.
* Rows a KV scatter writes twice (padding rows on the null page) keep
  their last value, so the pool is the same on every run.
* Engines on the reduced arctic twin, f32, temperature 0: the continuous
  engine (native and int8 KV, with and without n-gram speculation) and
  the static engine (``serve_bucketed`` and ``generate``, native and
  int8) are token- and counter-identical to the reference's, and the
  trace reconciles.

Under capacity routing the batch's token count T sets C and so which
replicas drop, in the reference as here: the static engine (a wave's
whole prompt is one T) and the continuous one (64-token chunks, B-slot
decode steps), or a verify window and a decode step, route different
token sets. So static == continuous and spec == spec-off, which hold for
the dense models, are not identities for MoE and are not asserted.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import MoEConfig
from repro.configs.reduce import reduced
from repro.models import RuntimeOptions
from repro.models import common as jcm
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.serving import ServeEngine as JaxEngine
import repro_torch.launch.serve as tserve
import repro_torch.models as tm
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.configs.reduce import reduced as treduced
from repro_torch.models import moe as tmoe
from repro_torch.serving import ServeEngine

torch.set_num_threads(2)

ARCHS = ["arctic-480b", "deepseek-v2-236b"]
OUT_TOL = dict(atol=1e-5, rtol=1e-5)
AUX_TOL = dict(atol=1e-6, rtol=1e-6)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(arch, **kw):
    return (reduced(get_config(arch), d_model=64, vocab=128, **kw),
            treduced(tget(arch), d_model=64, vocab=128, **kw))


@pytest.fixture(scope="module", params=ARCHS)
def ffn(request):
    """One MoE layer's weights from the reference's init_moe, in both
    packages."""
    cfg, tcfg = _cfgs(request.param)
    jp = jmoe.init_moe(jax.random.PRNGKey(0), cfg, jnp.float32)
    return cfg, tcfg, jp, tm.params_from_numpy(_np(jp), device="cpu")


def _x(T, seed=0):
    """Tokens (1, T, 64) sharing one direction, as hidden states do: the
    router then favours some experts, and at capacity_factor 1.25 some
    replicas drop."""
    rng = np.random.default_rng(seed + T)
    x = rng.standard_normal((1, T, 64), dtype=np.float32)
    return x + rng.standard_normal(64, dtype=np.float32)


def _reference_routing(p, x, cfg, capacity_factor):
    """The reference's routing and capacity slots (the lines of
    ``moe_ffn`` and ``_capacity_path`` that decide them): expert ids (T,
    k) and the slot table (E, C), each slot holding its replica index
    t * k + j, or T * k where empty."""
    m = cfg.moe
    xf = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(jcm.dense(p["router"], xf), axis=-1)
    _, expert_ids = jax.lax.top_k(probs, m.top_k)
    T, k = expert_ids.shape
    E = m.n_experts
    C = max(int(T * k * capacity_factor / E), 1)
    flat = expert_ids.reshape(-1)
    order = jnp.argsort(flat)
    sorted_eid = flat[order]
    start = jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(
        jnp.bincount(flat, length=E)).astype(jnp.int32)[:-1]])
    rank = jnp.arange(T * k, dtype=jnp.int32) - start[sorted_eid]
    dest = jnp.where(rank < C, sorted_eid * C + rank, E * C)
    slot = jnp.full((E * C,), T * k, jnp.int32).at[dest].set(
        order, mode="drop").reshape(E, C)
    return np.asarray(expert_ids), np.asarray(slot)


@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
@pytest.mark.parametrize("T", [2, 24])
def test_moe_ffn_capacity_matches_reference(ffn, T, capacity_factor):
    cfg, tcfg, jp, tp = ffn
    x = _x(T)
    want, want_aux = jmoe.moe_ffn(jp, jnp.asarray(x), cfg, impl="capacity",
                                  capacity_factor=capacity_factor)
    got, aux = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg, impl="capacity",
                            capacity_factor=capacity_factor)
    ids, slot = _reference_routing(jp, x, cfg, capacity_factor)
    xf = torch.from_numpy(x).reshape(T, -1)
    t_ids = tmoe._route(tp, xf, tcfg.moe.top_k)[-1]
    C = slot.shape[1]
    np.testing.assert_array_equal(t_ids.numpy(), ids)
    np.testing.assert_array_equal(
        tmoe._slots(t_ids, tcfg.moe.n_experts, C)[0].numpy(), slot)
    kept = np.unique(slot[slot < T * cfg.moe.top_k]).size
    assert (kept < T * cfg.moe.top_k) == (capacity_factor == 1.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    for name in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(aux[name]), float(want_aux[name]),
                                   **AUX_TOL, err_msg=name)


@pytest.mark.parametrize("T", [2, 24])
def test_moe_ffn_ragged_matches_reference(ffn, T):
    cfg, tcfg, jp, tp = ffn
    x = _x(T, seed=3)
    want, want_aux = jmoe.moe_ffn(jp, jnp.asarray(x), cfg, impl="ragged")
    got, aux = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg, impl="ragged")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    for name in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(aux[name]), float(want_aux[name]),
                                   **AUX_TOL, err_msg=name)


@pytest.mark.parametrize("T", [2, 24])
def test_capacity_equals_ragged_when_nothing_drops(ffn, T):
    """At capacity_factor = E every expert has room for every replica."""
    _, tcfg, _, tp = ffn
    x = torch.from_numpy(_x(T, seed=5))
    E = tcfg.moe.n_experts
    cap, _ = tmoe.moe_ffn(tp, x, tcfg, capacity_factor=float(E))
    rag, _ = tmoe.moe_ffn(tp, x, tcfg, impl="ragged")
    np.testing.assert_allclose(cap.numpy(), rag.numpy(), **OUT_TOL)


def test_slots_lower_replica_index_wins():
    """Replicas t * k + j sent to one expert take its C slots in index
    order (the stable sort of the reference's jnp.argsort); the rest drop."""
    ids = torch.tensor([[0, 1], [0, 1], [1, 0]])       # replicas 0..5
    slot, slot_of = tmoe._slots(ids, 2, 1)
    assert slot.tolist() == [[0], [1]]                 # replicas 0 and 1
    assert slot_of.tolist() == [0, 1, 2, 2, 2, 2]      # the rest: row E*C


def test_contested_slot_drops_the_later_token():
    """Two tokens routed to one expert with room for one (T=2, k=1, E=2,
    C=1): token 0 keeps the slot, token 1's routed output is exactly zero,
    as in the reference."""
    cfg, tcfg = _cfgs("arctic-480b")
    cfg = dataclasses.replace(cfg, moe=MoEConfig(n_experts=2, top_k=1,
                                                 d_ff_expert=8))
    tcfg = dataclasses.replace(tcfg, moe=TMoEConfig(n_experts=2, top_k=1,
                                                    d_ff_expert=8))
    jp = _np(jmoe.init_moe(jax.random.PRNGKey(4), cfg, jnp.float32))
    jp["router"]["w"] = np.zeros((64, 2), np.float32)
    jp["router"]["w"][0, 0] = 10.0                     # feature 0 -> expert 0
    x = np.random.default_rng(2).standard_normal((1, 2, 64)).astype(
        np.float32)
    x[..., 0] = 1.0
    tp = tm.params_from_numpy(jp, device="cpu")
    got, _ = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg, capacity_factor=1.0)
    want, _ = jmoe.moe_ffn(jp, jnp.asarray(x), cfg, capacity_factor=1.0)
    assert float(got[0, 0].abs().max()) > 0
    assert torch.equal(got[0, 1], torch.zeros(64))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


def test_shard_map_raises_naming_item_9(ffn):
    _, tcfg, _, tp = ffn
    with pytest.raises(NotImplementedError, match="item 9"):
        tmoe.moe_ffn(tp, torch.zeros((1, 2, 64)), tcfg, impl="shard_map")
    with pytest.raises(ValueError, match="impl"):
        tmoe.moe_ffn(tp, torch.zeros((1, 2, 64)), tcfg, impl="dense")


# ------------------------------- model ---------------------------------- #

@pytest.fixture(scope="module")
def model():
    """The reduced arctic-480b twin (3 MoE layers, 8 experts top-2, a dense
    residual FFN), the reference's f32 weights in both packages."""
    cfg, tcfg = _cfgs("arctic-480b")
    jp = jlm.init_params(cfg, jax.random.PRNGKey(0),
                         RuntimeOptions(dtype="float32"))
    return cfg, tcfg, jp, tm.params_from_numpy(_np(jp), device="cpu")


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).split(".")[-1])


def test_init_params_has_the_reference_layout(model):
    """The port's own init builds the reference's tree: a stacked ``moe``
    subtree in place of ``mlp``, the router f32 in a bf16 model; and the
    bridge keeps the router f32 when it casts the rest."""
    cfg, tcfg, _, _ = model
    jp = jlm.init_params(cfg, jax.random.PRNGKey(1),
                         RuntimeOptions(dtype="bfloat16"))
    tp = tm.init_params(tcfg, torch.Generator().manual_seed(0), "bfloat16",
                        "cpu")
    assert _shapes(tp) == _shapes(_np(jp))
    assert "mlp" not in tp["stack"]
    conv = tm.params_from_numpy(_np(jp), device="cpu", dtype="float16")
    assert conv["stack"]["moe"]["router"]["w"].dtype == torch.float32
    assert conv["stack"]["moe"]["w_up"].dtype == torch.float16


def test_forward_matches_reference(model):
    cfg, tcfg, jp, tp = model
    toks = np.random.default_rng(1).integers(1, cfg.vocab, size=(3, 9))
    toks = toks.astype(np.int32)
    want, _ = jlm.forward(cfg, jp, jnp.asarray(toks),
                          RuntimeOptions(dtype="float32"))
    got = tm.forward(tcfg, tp, torch.from_numpy(toks),
                     tm.RuntimeOptions(dtype="float32"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_supported_on_both_paths_but_not_first_dense():
    tcfg = tget("arctic-480b")
    assert tm.paged_supported(tcfg) is None
    assert tm.static_supported(tcfg) is None
    from repro_torch.models import lm as tlm
    # dense prefix layers (moe.first_dense) run on the static path only,
    # and the paged path refuses them with the reference's reason
    no_mla = dataclasses.replace(tget("deepseek-v2-236b"), mla=None)
    assert tm.static_supported(no_mla) is None
    assert tlm.paged_supported(no_mla) == (
        "unscanned prefix layers not supported by the paged cache")


def test_duplicate_kv_writes_keep_the_last():
    """Rows written twice in one scatter (padding rows, all on the null
    page) hold their last value, as a sequential scatter leaves them: the
    pool a step leaves is the same on every run and device, which MoE
    routing needs (padding rows read the null page and compete for
    expert slots)."""
    from repro_torch.models import lm as tlm
    kp, vp = torch.zeros((2, 4, 1, 2)), torch.zeros((2, 4, 1, 2))
    # pages of 4 rows, a table of [page 1, null page]: positions 5 and 9,
    # 13 (past the table) all land on null-page row 1
    rows = tlm._kv_rows(torch.tensor([[1, 0]]),
                        torch.tensor([[1, 5, 9, 2, 13, 1]]), 4)
    assert rows[0].tolist() == [5, 1, 1, 6, 1, 5]
    k = torch.arange(12, dtype=torch.float32).reshape(6, 1, 2)
    tlm._write_kv(kp, vp, rows, k, -k)
    rows = kp.view(8, 1, 2)
    assert torch.equal(rows[1], k[4]) and torch.equal(rows[5], k[5])
    assert torch.equal(rows[6], k[3]) and torch.equal(vp, -kp)
    assert float(rows[[0, 2, 3, 4, 7]].abs().sum()) == 0


# ------------------------------- engines -------------------------------- #

KW = dict(max_len=40, scheduler="continuous", page_size=4, max_batch=4,
          prefill_chunk=8, decode_lookahead=8, overlap=False)
NEW = 6
COUNTERS = ("host_syncs", "prefill_tokens_computed", "cow_copies",
            "peak_pages_used", "cached_prefix_tokens", "decode_steps",
            "decode_compiles", "preemptions", "new_tokens", "spec_blocks",
            "draft_proposed", "draft_accepted")
STATIC_COUNTERS = ("host_syncs", "decode_steps", "decode_compiles",
                   "new_tokens", "requests")


def _requests(vocab):
    """Six ragged prompts; two share a prefix with a finished request, so
    pages are deduped and one is copied on write (page_size 4)."""
    rng = np.random.default_rng(11)
    doc = rng.integers(1, vocab, size=12).tolist()
    return ([doc[:10]]
            + [rng.integers(1, vocab, size=n).tolist() for n in (5, 13, 8)]
            + [doc[:9] + [99, 98, 97], doc + [7, 7]])


def _static_requests(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(1, vocab, size=n).tolist()
            for n in (5, 7, 5, 9, 7, 5, 9)]


def _stats(eng, names):
    return {c: getattr(eng.stats, c) for c in names}


@pytest.mark.parametrize("spec", ["off", "ngram"])
@pytest.mark.parametrize("kv_policy", ["native", "int8"])
def test_continuous_engine_matches_reference(model, kv_policy, spec):
    cfg, tcfg, jp, tp = model
    kw = dict(KW, kv_policy=kv_policy, spec_mode=spec, spec_k=4)
    reqs = _requests(cfg.vocab)
    ref = JaxEngine(cfg, jp, RuntimeOptions(dtype="float32"), **kw)
    want = ref.serve([r[:] for r in reqs], NEW)
    eng = ServeEngine(tcfg, tp, tm.RuntimeOptions(dtype="float32"),
                      device="cpu", **kw)
    assert eng.serve([r[:] for r in reqs], NEW) == want
    assert _stats(eng, COUNTERS) == _stats(ref, COUNTERS)
    assert eng.trace_report["ok"] and eng.kv_manager.n_used == 0
    assert eng.stats.cow_copies >= 1
    if spec == "ngram":
        assert eng.stats.spec_blocks > 0


@pytest.mark.parametrize("kv_policy", ["native", "int8"])
def test_static_engine_matches_reference(model, kv_policy):
    """serve_bucketed (a wave a length bucket) and generate on one wave."""
    cfg, tcfg, jp, tp = model
    kw = dict(max_len=40, kv_policy=kv_policy, decode_lookahead=8)
    reqs = _static_requests(cfg.vocab)
    ref = JaxEngine(cfg, jp, RuntimeOptions(dtype="float32"), **kw)
    eng = ServeEngine(tcfg, tp, tm.RuntimeOptions(dtype="float32"),
                      device="cpu", scheduler="static", **kw)
    assert eng.serve([r[:] for r in reqs], 11) == ref.serve(
        [r[:] for r in reqs], 11)
    assert _stats(eng, STATIC_COUNTERS) == _stats(ref, STATIC_COUNTERS)
    wave = np.asarray(reqs[:3:2] + reqs[5:6])              # three of length 5
    assert eng.generate(wave, 9) == ref.generate(wave, 9)
    assert _stats(eng, STATIC_COUNTERS) == _stats(ref, STATIC_COUNTERS)


@pytest.mark.parametrize("scheduler", ["static", "continuous"])
def test_serve_cli_moe(capsys, scheduler):
    tserve.main(["--arch", "arctic-480b", "--reduced", "--d-model", "64",
                 "--device", "cpu", "--scheduler", scheduler,
                 "--concurrency", "3", "--prompt-len", "10",
                 "--new-tokens", "5", "--page-size", "4",
                 "--prefill-chunk", "8"])
    out = capsys.readouterr().out
    assert (f"[serve] arch=arctic-480b device=cpu sched={scheduler} "
            f"kv=native reqs=3 ") in out
    assert "TPS=" in out and "[serve] first output:" in out
