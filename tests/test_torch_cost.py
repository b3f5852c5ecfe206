"""The op-level cost extractor (``repro_torch.core.cost_analysis``) and the
H100 roofline (``core/h100_roofline.py``): on a reduced dense twin's decode
step and prefill, its matrix-product FLOPs are the analytic workload's
GEMM FLOPs (attention apart, and bounded), its bytes are at least the
compulsory ones, its collective bytes over 2 gloo ranks are the sharded
path's all-gather result bytes; ``h100_roofline`` given v5e constants is
``tpu_roofline``; and the H100 chain's decode step is the byte floor."""
import pathlib

import pytest
import torch

from repro.configs import ASSIGNED_ARCHS, PAPER_ARCHS
from repro.configs import get_config as jget
from repro.core import tpu_roofline
from repro.core.hlo_analysis import HloCosts
from repro.core.memspec import V5E_HBM_BW, V5E_ICI_BW, V5E_PEAK_BF16
import repro_torch.models as tm
from repro_torch.configs import get_config
from repro_torch.configs.reduce import reduced
from repro_torch.core import (decode_phase, make_placement, phase_time,
                              prefill_phase, run_inference)
from repro_torch.core import h100_roofline as h100
from repro_torch.core.cost_analysis import OpCosts, analyze
from repro_torch.launch.ranks import run_ranks

import torch_cost_ranks as ranks

torch.set_num_threads(2)

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
B, PS, NPP = 4, 8, 5          # slots, page size, pages a slot's table row


@pytest.fixture(scope="module")
def twin():
    cfg = reduced(get_config("llama3.2-1b"), d_model=64, n_layers=2,
                  vocab=128)
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), "float32",
                            "cpu")
    return cfg, params, tm.RuntimeOptions(dtype="float32")


def _gemm_flops(phase):
    """The phase's GEMM FLOPs: (attention, every other GEMM)."""
    attn = other = 0.0
    for k in phase.kernels:
        if k.kind == "gemm":
            if k.group == "attn":
                attn += k.total_flops()
            else:
                other += k.total_flops()
    return attn, other


def _decode_costs(cfg, params, opts, cached):
    cache = tm.init_paged_cache(cfg, 1 + B * NPP, PS, opts, "cpu")
    pt = torch.arange(1, B * NPP + 1, dtype=torch.int32).reshape(B, NPP)
    seq = torch.full((B,), cached, dtype=torch.int32)
    tok = torch.arange(1, B + 1, dtype=torch.int32)
    return analyze(tm.decode_step_paged, cfg, params, tok, seq, pt, cache,
                   opts)


@pytest.mark.parametrize("cached", [7, 30, 39])
def test_decode_flops_are_the_workload_gemms(twin, cached):
    """The weight products are the workload's exactly. The attention
    products differ by the plain paged decode's width: it scores every key
    of a slot's table row (NPP x PS), masked past the valid ones, where the
    model counts the ``cached + 1`` valid keys."""
    cfg, params, opts = twin
    c = _decode_costs(cfg, params, opts, cached)
    attn, other = _gemm_flops(decode_phase(cfg, cached + 1, B, 4))
    assert c.flops_by_op["aten.mm"] == other
    assert c.flops_by_op["aten.bmm"] == pytest.approx(
        attn * NPP * PS / (cached + 1), rel=1e-12)
    assert attn <= c.flops_by_op["aten.bmm"] <= attn * NPP * PS
    assert c.flops == other + c.flops_by_op["aten.bmm"]


@pytest.mark.parametrize("S", [8, 24])
def test_prefill_flops_are_the_workload_gemms(twin, S):
    """The plain flash version scores the whole S x S block (masked); the
    model counts the causal half: the attention products are twice its."""
    cfg, params, opts = twin
    cache = tm.init_cache(cfg, 2, S, opts, "cpu")
    toks = torch.randint(1, cfg.vocab, (2, S), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    c = analyze(tm.prefill, cfg, params, toks, cache, opts)
    attn, other = _gemm_flops(prefill_phase(cfg, S, 2, 4))
    assert c.flops_by_op["aten.mm"] == other
    assert c.flops_by_op["aten.bmm"] == 2 * attn


@pytest.mark.parametrize("cached", [7, 39])
def test_decode_bytes_cover_the_compulsory_bytes(twin, cached):
    cfg, params, opts = twin
    c = _decode_costs(cfg, params, opts, cached)
    floor = h100.decode_compulsory_bytes(cfg, cached + 1, B, 1, 4)
    assert c.bytes >= floor
    assert sum(c.bytes_by_op.values()) == pytest.approx(c.bytes, rel=1e-12)
    assert c.collective_bytes == 0.0 and c.collective_counts == {}


def test_bytes_of_gathers_views_and_in_place_updates():
    src = torch.zeros(1000, 16)
    idx = torch.tensor([3, 5])
    c = analyze(lambda: src[idx])                 # the rows, not the table
    assert c.bytes == 2 * 2 * 16 * 4 + 2 * 8
    c = analyze(lambda: src.view(16, 1000).t())   # views move nothing
    assert c.bytes == 0.0
    c = analyze(lambda: src.t().reshape(-1))      # a copy, then a view
    assert c.bytes == 2 * 1000 * 16 * 4
    assert set(c.bytes_by_op) == {"aten.clone"}
    upd = torch.ones(2, 16)
    c = analyze(lambda: src.index_copy_(0, idx, upd))
    assert c.bytes == 2 * (2 * 8 + 2 * 16 * 4)    # the update, not the target
    c = analyze(lambda: torch.mm(upd, src[:16]))
    assert c.flops == 2 * 2 * 16 * 16
    assert c.bytes == (2 * 16 + 16 * 16 + 2 * 16) * 4


def test_meta_tensors_count_without_data():
    a = torch.empty(64, 128, device="meta")
    b = torch.empty(128, 32, device="meta")
    c = analyze(torch.mm, a, b)
    assert c.flops == 2 * 64 * 128 * 32
    assert c.bytes == (64 * 128 + 128 * 32 + 64 * 32) * 4


def test_collective_bytes_over_two_gloo_ranks(twin):
    """Each layer all-gathers the two ranks' (B, H/2, dh) head outputs: the
    result, (B, H, dh) in f32, is what each rank counts, as
    ``hlo_analysis`` counts an all-gather's result bytes; an all-reduce
    counts its result too."""
    cfg = twin[0]
    outs = run_ranks(ranks.sharded_decode_costs, 2, (cfg, B, PS, NPP),
                     timeout=120)
    want = cfg.n_layers * B * cfg.n_heads * cfg.head_dim * 4
    for sharded, kinds, unsharded, reduced in outs:
        assert sharded == want and kinds == {"all-gather": want}
        assert unsharded == 0.0
        assert reduced == {"all-reduce": 8 * 4}


# ----------------------------- h100_roofline ---------------------------- #

def test_terms_with_v5e_constants_are_tpu_roofline():
    costs = HloCosts(flops=3.1e13, bytes=7.7e10, collective_bytes=2.5e9)
    mine = OpCosts(flops=3.1e13, bytes=7.7e10, collective_bytes=2.5e9)
    want = tpu_roofline.terms_from_costs(costs, n_dev=256, model_flops=5e15)
    for c in (costs, mine):
        got = h100.terms_from_costs(c, n_dev=256, model_flops=5e15,
                                    peak=V5E_PEAK_BF16, hbm_bw=V5E_HBM_BW,
                                    link_bw=V5E_ICI_BW)
        assert got.__dict__ == want.__dict__
        assert (got.bottleneck, got.step_lower_bound_s, got.roofline_fraction,
                got.model_flops_ratio) == (
            want.bottleneck, want.step_lower_bound_s, want.roofline_fraction,
            want.model_flops_ratio)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS + PAPER_ARCHS)
def test_floors_with_v5e_constants_are_tpu_roofline(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    for kind in ("train", "prefill", "decode"):
        assert (h100.model_flops_for(cfg, kind, 4096, 8)
                == tpu_roofline.model_flops_for(jcfg, kind, 4096, 8))
    for ctx, batch, n_dev in ((1088, 4, 1), (32192, 1, 256)):
        assert (h100.decode_compulsory_bytes(cfg, ctx, batch, n_dev)
                == tpu_roofline.decode_compulsory_bytes(jcfg, ctx, batch,
                                                        n_dev))
        assert (h100.decode_floor_seconds(cfg, ctx, batch, n_dev,
                                          hbm_bw=V5E_HBM_BW)
                == tpu_roofline.decode_floor_seconds(jcfg, ctx, batch,
                                                     n_dev))


@pytest.mark.parametrize("batch,ctx", [(1, 32192), (4, 1088)])
def test_h100_decode_step_is_the_byte_floor(batch, ctx):
    """With HBM latency 0 (the default), llava15-13b's decode step on the
    published H100 is within 2% of (weights + KV) / 3.35 TB/s; a 0.5 us
    latency a chunk would put it 18-88% above."""
    cfg = get_config("llava15-13b")
    place = make_placement("all-hbm", "ddr")
    floor = ((cfg.n_active_params() * 2
              + cfg.kv_bytes_per_token(2) * ctx * batch) / 3.35e12)
    step = phase_time(decode_phase(cfg, ctx, batch, 2), h100.h100_hierarchy(),
                      place)
    assert step.total == pytest.approx(floor, rel=0.02)
    assert step.bottleneck == "ddr"
    slow = phase_time(decode_phase(cfg, ctx, batch, 2),
                      h100.h100_hierarchy(hbm_latency=0.5e-6), place)
    assert slow.total > 1.15 * floor


def test_h100_hierarchy_takes_measured_figures():
    h = h100.h100_hierarchy(flops=7e14, hbm_bw=3.0e12, host_bw=5.5e10,
                            host_latency=1e-5)
    assert [lv.name for lv in h.chain] == ["smem", "l2", "ddr", "hbs"]
    assert h.compute.flops == 7e14
    assert h.level("ddr").bandwidth == 3.0e12
    assert h.level("ddr").capacity == 80e9 and h.level("ddr").latency == 0.0
    assert (h.level("hbs").bandwidth, h.level("hbs").latency) == (5.5e10,
                                                                  1e-5)
    assert h100.H100_SM_CLOCK == pytest.approx(1.83e9, rel=1e-3)


def test_required_host_bandwidth_brackets_the_target():
    """llava15-13b with its KV in host DRAM at 32k: the least host rate
    that holds 10 tokens/s of decode, and 2% below it falls short."""
    cfg = get_config("llava15-13b")
    place = make_placement("kv-host", "ddr", kv="hbs")
    hier = h100.h100_hierarchy()
    bw = h100.required_level_bandwidth(cfg, hier, place, target_tps=10.0,
                                       prefill=32128, decode=64)
    assert bw is not None and bw > h100.H100_PCIE_BW / 1e9

    def tps(gbps):
        h = hier.with_level("hbs", bandwidth=gbps * 1e9)
        return run_inference(cfg, h, place, 32128, 64,
                             n_samples=5).tps_decode_only
    assert tps(bw) >= 10.0 > tps(bw / 1.03)
    assert h100.required_level_bandwidth(cfg, hier, place, target_tps=1e6,
                                         prefill=32128, decode=64) is None


def test_extractor_imports_neither_jax_nor_the_reference():
    for name in ("cost_analysis", "h100_roofline"):
        text = (SRC / "repro_torch" / "core" / f"{name}.py").read_text()
        assert "jax" not in text and "from repro." not in text
        assert "import repro." not in text
