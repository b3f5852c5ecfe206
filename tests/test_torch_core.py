"""The port's analytic model (``repro_torch.core``) against the reference's:
the six modules are copies that differ only in their import lines, every
export of ``repro.core`` has its counterpart, and the model's answers are
equal, float for float and label for label, for every config under the
paper's NPU+HBS and chiplet hierarchies and the v5e chain, each package
building the hierarchy with its own ``memspec``."""
import pathlib

import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.configs import ASSIGNED_ARCHS, PAPER_ARCHS
from repro.configs import get_config as jget
from repro.core import stco as jstco
from repro_torch.configs import get_config as tget
from repro_torch.core import stco as tstco
from torch_copy_helpers import same_but_imports

torch.set_num_threads(2)

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
CORE_COPIES = ("workload", "tiling", "placement", "roofline", "concurrency",
               "stco", "memspec")
ARCHS = ASSIGNED_ARCHS + PAPER_ARCHS
HIERS = ("npu+hbs", "npu+chiplet", "v5e")


@pytest.mark.parametrize("name", CORE_COPIES)
def test_core_copy_differs_only_in_imports(name):
    port = (SRC / "repro_torch" / "core" / f"{name}.py").read_text()
    ref = (SRC / "repro" / "core" / f"{name}.py").read_text()
    assert ("repro_torch." in port) == ("repro." in ref)
    assert same_but_imports(port, ref)


def test_same_but_imports_refuses_other_edits():
    ref = "from repro.core import x\ny = 1\n"
    assert same_but_imports("from repro_torch.core import x\ny = 1\n", ref)
    assert not same_but_imports("from repro_torch.core import x\ny = 2\n",
                                ref)
    assert not same_but_imports("from repro_torch.core import z\ny = 1\n",
                                ref)


def test_exports_cover_the_reference():
    """Every name ``repro.core`` exports, but for its TPU retargeting
    module ``tpu_roofline``, whose counterpart is ``h100_roofline``."""
    missing = set(jcore.__all__) - set(tcore.__all__)
    assert missing == {"tpu_roofline"}
    assert "h100_roofline" in tcore.__all__
    for name in tcore.__all__:
        assert hasattr(tcore, name)


# --------------------------- equal answers ---------------------------- #

def _hierarchy(pkg, name):
    """(hierarchy, placement) of ``name`` built by ``pkg``'s own core."""
    if name == "npu+hbs":
        return (pkg.npu_hierarchy(pkg.lpddr6(520.0),
                                  pkg.hbs(64.0, latency_us=20.0)),
                pkg.qkv_in_ddr())
    if name == "npu+chiplet":
        return (pkg.npu_hierarchy(pkg.lpddr6(173.0),
                                  pkg.hbs(64.0, latency_us=20.0),
                                  chiplet=pkg.sram_chiplet(512.0)),
                pkg.chiplet_qkv())
    return pkg.tpu_v5e_hierarchy(), pkg.make_placement("all-hbm", "hbm")


def _phase(r):
    return (r.phase, r.total, r.by_group, r.by_level, r.compute_time,
            r.bottleneck, [(k.kernel.name, k.time, k.bottleneck,
                            k.level_traffic, k.level_chunks)
                           for k in r.kernel_times])


def _report(rep):
    return (rep.arch, rep.prefill_len, rep.decode_len, rep.batch,
            rep.placement, rep.tps, rep.total_time, rep.prefill_time,
            rep.decode_time, rep.bottleneck, _phase(rep.prefill),
            [(x, _phase(r)) for x, r in rep.decode_samples])


def _point(p):
    return (p.n_concurrent, _report(p.report), p.kv_bytes, p.kv_locations,
            p.kv_preferred, p.aggregate_tps, p.per_request_tps,
            p.kv_spill_frac, p.bottleneck)


def _both(arch, hier, fn):
    """``fn(pkg, cfg, hierarchy, placement)`` in each package, or the type
    of what it raised."""
    out = []
    for pkg, get in ((jcore, jget), (tcore, tget)):
        h, place = _hierarchy(pkg, hier)
        try:
            out.append(fn(pkg, get(arch), h, place))
        except (KeyError, ValueError) as e:
            out.append((type(e).__name__, str(e)))
    return out


@pytest.mark.parametrize("hier", HIERS)
@pytest.mark.parametrize("arch", ARCHS)
def test_inference_and_concurrency_equal(arch, hier):
    def fn(pkg, cfg, h, place):
        return (
            _report(pkg.run_inference(cfg, h, place, 512, 256, batch=2)),
            [_point(p) for p in pkg.concurrency_sweep(
                cfg, h, place, concurrency=(1, 4, 16), prefill_len=1024,
                decode_len=128)],
            pkg.max_concurrency_without_spill(
                cfg, h, place, prefill_len=2048, decode_len=256),
            pkg.max_concurrency_without_spill(
                cfg, h, place, prefill_len=2048, decode_len=256,
                shared_prefix_len=1536, share_group=4))
    want, got = _both(arch, hier, fn)
    assert got == want


@pytest.mark.parametrize("hier", HIERS)
@pytest.mark.parametrize("arch", ARCHS)
def test_interactivity_sweeps_equal(arch, hier):
    def fn(pkg, cfg, h, place):
        grid = pkg.hbs_interactivity_sweep(
            cfg, h, place, bw_gbps=(4.0, 32.0), latency_us=(5.0, 80.0),
            prefill_len=2048, decode_len=64)
        chip = pkg.chiplet_interactivity_sweep(
            cfg, h, place, chiplet_mb=(32.0, 128.0), bw_gbps=(4.0, 32.0),
            latency_us=(5.0, 80.0), prefill_len=2048, decode_len=64,
            kv_dtype_bytes=1)
        return ([(g.bw_gbps, g.latency_us, g.tps, g.itl_s, g.kv_spill_frac,
                  _point(g.point)) for g in grid],
                [(c.chiplet_mb, c.hit_frac, c.itl_s, c.tps) for c in chip])
    want, got = _both(arch, hier, fn)
    assert got == want
    if hier == "v5e":         # no "hbs" level: both refuse alike
        assert got[0] == "KeyError"


@pytest.mark.parametrize("arch", ARCHS)
def test_stco_and_speculation_equal(arch):
    def fn(stco, pkg, cfg):
        return (stco.required_bandwidth(cfg, pkg.qkv_in_ddr(),
                                        target_tps=10.0),
                stco.max_tolerable_latency(cfg, pkg.qkv_in_ddr(),
                                           target_tps=10.0),
                [pkg.speculative_tps(37.5, a, k, overhead_frac=0.1)
                 for a in (0.0, 0.6, 1.0) for k in (1, 4)])
    assert (fn(tstco, tcore, tget(arch)) == fn(jstco, jcore, jget(arch)))


# ------------------------------ Table I ------------------------------- #

TABLE1 = [  # tests/test_paper_claims.py's rows: the paper's TPS and bottleneck
    (173.0, 173.0, "all_hbs", 4.0, "hbs"),
    (173.0, 520.0, "all_hbs", 5.5, "ddr"),
    (520.0, 512.0, "all_hbs", 8.9, "hbs"),
    (520.0, 512.0, "qkv_in_ddr", 12.5, "hbs"),
]


@pytest.mark.parametrize("ddr_bw,hbs_bw,place,paper_tps,paper_bott", TABLE1)
def test_table1_row_on_the_port(ddr_bw, hbs_bw, place, paper_tps, paper_bott):
    hier = tcore.npu_hierarchy(tcore.lpddr6(ddr_bw),
                               tcore.hbs(hbs_bw, latency_us=10.0))
    rep = tcore.run_inference(tget("llava15-13b"), hier,
                              getattr(tcore, place)(), 200, 200,
                              dtype_bytes=2)
    assert rep.tps == pytest.approx(paper_tps, rel=0.20)
    assert rep.bottleneck == paper_bott


def test_table1_gain_ordering_on_the_port():
    tps = []
    for ddr_bw, hbs_bw, place, _, _ in TABLE1:
        hier = tcore.npu_hierarchy(tcore.lpddr6(ddr_bw),
                                   tcore.hbs(hbs_bw, latency_us=10.0))
        tps.append(tcore.run_inference(tget("llava15-13b"), hier,
                                       getattr(tcore, place)(), 200,
                                       200).tps)
    assert tps[0] < tps[1] < tps[2] < tps[3]
    assert tps[3] >= 10.0 and tps[2] < 10.0
