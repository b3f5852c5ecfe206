"""The port's continuous engine under the paper's two memory levers, held
against the reference engine on the same reduced llama3.2-1b twin, the
same f32 weights and the same requests: HBS offload with layer-sliced
migration and with the whole-block barrier, a chiplet promotion level,
the shared write-back link, and the chiplet over an int8 pool (the
counterparts of ``tests/test_tier_residency.py``'s engine-level cases).

Both engines run their prefill and decode on one stream
(``overlap=False``), so the schedule, and with it every page counter,
follows the requests and not the measured step times. Two counters still
follow the step times and are not compared: prefetch hits and misses,
and which tier each touch read (its total is compared); see
``repro_torch.paper.common.SCHEDULE_COUNTERS``."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.reduce import reduced
from repro.core import hbs as jhbs
from repro.core import lpddr6 as jlpddr6
from repro.core import npu_hierarchy as jnpu_hierarchy
from repro.core import sram_chiplet as jsram_chiplet
from repro.models import RuntimeOptions
from repro.models import lm as jlm
from repro.serving import ServeEngine as JaxEngine
import repro_torch.models as tm
from repro_torch.configs import get_config as tget
from repro_torch.configs.reduce import reduced as treduced
from repro_torch.core import hbs, lpddr6, npu_hierarchy, sram_chiplet
from repro_torch.paper.common import schedule_counters
from repro_torch.serving import ServeEngine
from repro_torch.serving.kv_manager import page_bytes

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models():
    cfg = reduced(get_config("llama3.2-1b"), d_model=64, n_layers=2,
                  vocab=128)
    tcfg = treduced(tget("llama3.2-1b"), d_model=64, n_layers=2, vocab=128)
    jp = jlm.init_params(cfg, jax.random.PRNGKey(0),
                         RuntimeOptions(dtype="float32"))
    tp = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return cfg, tcfg, jp, tp


def _hierarchies(tcfg, fast_pages, chiplet_pages, dtype_bytes, page_size=8):
    """The same fast/HBS(/chiplet) hierarchy built by each package's own
    memspec, its tiers sized in pages at the pool's width (the reference
    test's ``_offload_hierarchy`` and ``_chiplet_hierarchy``)."""
    pb = page_bytes(tcfg, page_size, dtype_bytes)
    out = []
    for npu, ddr, store, chip in ((jnpu_hierarchy, jlpddr6, jhbs,
                                   jsram_chiplet),
                                  (npu_hierarchy, lpddr6, hbs, sram_chiplet)):
        chiplet = (chip(512.0, capacity_mb=chiplet_pages * pb / 1e6)
                   if chiplet_pages else None)
        out.append(npu(ddr(capacity_gb=fast_pages * pb / 1e9),
                       store(8.0, latency_us=20.0, capacity_gb=1.0),
                       chiplet=chiplet))
    return out


# (requests' seed and lengths, new tokens, max_len, fast pages, chiplet
# pages, HBS GB/s and µs; engine options): the reference test's
# layer-overlap case (:755) with its barrier and its shared link, and its
# chiplet case (:788) native and over int8. On one stream the chiplet
# case's 8 new tokens are one decode block, after which no page has been
# touched on the consecutive rounds that promote it; 16 make two.
_OVERLAP = ((6, (20, 9, 14)), 8, 40, 4, 0, 1e-3, 500.0)
_CHIPLET = ((7, (16, 16, 16)), 16, 32, 3, 2, 0.01, 20.0)
CASES = {
    "layer_overlap": (_OVERLAP, {}),
    "barrier": (_OVERLAP, dict(layer_overlap=False)),
    "shared_link": (_OVERLAP, dict(writeback_link="shared")),
    "chiplet": (_CHIPLET, dict(chiplet_gbps=512.0, chiplet_latency_us=0.05)),
    "chiplet_int8": (_CHIPLET, dict(chiplet_gbps=512.0,
                                    chiplet_latency_us=0.05,
                                    kv_policy="int8")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tiered_engine_equals_the_reference(models, case):
    cfg, tcfg, jp, tp = models
    ((seed, lens), new, max_len, fast, chip, gbps, lat_us), extra = (
        CASES[case])
    rng = np.random.default_rng(seed)
    reqs = [rng.integers(1, cfg.vocab, size=n).tolist() for n in lens]
    kw = dict(max_len=max_len, scheduler="continuous", page_size=8,
              max_batch=3, prefill_budget=96, overlap=False,
              kv_policy=extra.get("kv_policy", "native"))
    okw = dict(hbs_gbps=gbps, hbs_latency_us=lat_us,
               **{k: v for k, v in extra.items() if k != "kv_policy"})
    int8 = kw["kv_policy"] == "int8"
    jh, th = _hierarchies(tcfg, fast, chip, 1 if int8 else 4)
    ref = JaxEngine(cfg, jp, RuntimeOptions(dtype="float32"), hierarchy=jh,
                    **kw, **okw)
    want = ref.serve([r[:] for r in reqs], new)
    base = ServeEngine(tcfg, tp, tm.RuntimeOptions(dtype="float32"),
                       device="cpu", **kw)
    no_offload = base.serve([r[:] for r in reqs], new)
    eng = ServeEngine(tcfg, tp, tm.RuntimeOptions(dtype="float32"),
                      device="cpu", hierarchy=th, **kw, **okw)
    got = eng.serve([r[:] for r in reqs], new)
    assert got == want == no_offload
    assert eng.n_layer_slices == ref.n_layer_slices
    s, r = eng.stats, ref.stats
    # equal pages per channel over equal page bytes: equal channel bytes
    assert eng.page_nbytes == ref.page_nbytes
    assert (schedule_counters(s, eng.page_nbytes)
            == schedule_counters(r, ref.page_nbytes))
    assert s.pages_fetched > 0 and s.stall_s > 0.0     # it really streamed
    if extra.get("layer_overlap", True):
        assert eng.n_layer_slices == tcfg.n_layers == 2
        assert s.stall_saved_s > 0.0
        # the same serve with the whole-block barrier: its stall follows
        # the schedule, and layer slicing never stalls more
        barrier = ServeEngine(tcfg, tp, tm.RuntimeOptions(dtype="float32"),
                              device="cpu", hierarchy=th, **kw, **okw,
                              layer_overlap=False)
        assert barrier.serve([q[:] for q in reqs], new) == want
        assert s.stall_s <= barrier.stats.stall_s
    else:
        assert eng.n_layer_slices == 1 and s.stall_saved_s == 0.0
    if chip:
        assert s.chiplet_promotions > 0
        assert s.tier_touches.get("chiplet", 0) > 0
    assert s.channel_bytes.get("ddr->chiplet", 0.0) == (
        s.chiplet_promotions * eng.page_nbytes)
    assert eng.page_nbytes == page_bytes(tcfg, 8, 1 if int8 else 4)
    assert eng.trace_report["ok"] and eng.kv_manager.n_used == 0
