"""The port's dry run (``repro_torch.launch.dryrun``: the step as a
DTensor program over a fake process group, traced once under
``FakeTensorMode``) against the reference's compiled dry run.

The reference's ``build_cell`` is lowered and compiled by XLA on a (2, 4)
("data", "model") mesh of 8 host devices with Auto axes (a subprocess:
``torch_ref_mesh.py``); the port traces the same cell on a fake (2, 4)
mesh. Per rank:

* ``argument_bytes`` equals XLA's ``argument_size_in_bytes`` exactly: the
  sharding rules put the same bytes of every parameter, cache and input on
  a device (the decode ``pos`` scalar's 4 bytes included).
* FLOPs are within 1.5x either way of the matrix-product FLOPs of the
  compiled HLO (``hlo_analysis``'s dot FLOPs, trip-count aware). Its
  total adds each fusion's output bytes as elementwise FLOPs
  (``core/hlo_analysis.py:306``), which the port's extractor (matrix
  products only) has no counterpart of: the test prints both ratios. A
  dropped or doubled sharding would show as a factor of 2, 4 or 8.
* Peak bytes against XLA's argument + temp bytes: a prefill holds the
  same projections and blocks of scores in both, within 1.5x either way;
  a decode updates its caches in place on the port, while XLA's temp
  also holds the copies of the stacked cache its partitioner makes where
  it cannot reshard it (its "Involuntary full rematerialization"
  warnings), so the port's temp bytes are at most XLA's.
* Doubling the data axis ((2, 2) to (4, 2)) halves a rank's batch: its
  FLOPs halve, and its argument bytes (equal to XLA's on both meshes)
  and peak bytes fall.

The train cell (micro-batches, ZeRO-1 state) is in
``test_torch_dryrun_train.py``."""
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.configs import get_config as jget
from repro.launch import dryrun as jdryrun
from repro.models import cell_runnable as jcell_runnable
from repro_torch.core.cost_analysis import analyze
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshShape, fake_process_group, mesh_over

torch.set_num_threads(2)

HERE = pathlib.Path(__file__).resolve().parent
MESH = MeshShape(("data", "model"), (2, 4))
# (arch, shape, variant): the seq-shard branch (Hkv 2 does not divide 4);
# ZeRO-3 gathers; a flash-routed prefill whose kv heads (2) do not divide
# the model axis (each rank's 4 query heads read one kv head); the
# expert-parallel MoE branch
CELLS = [("qwen2.5-3b", "decode_32k", "tp"),
         ("llama3.2-1b", "prefill_32k", "fsdp"),
         ("qwen2.5-3b", "prefill_32k", "fsdp"),
         ("arctic-480b", "decode_32k", "fsdp")]


def xla_cells(cells, mesh=(2, 4), remat="none"):
    """The reference's compiled cells on a ("data", "model") Auto mesh."""
    with tempfile.TemporaryDirectory() as tmp:
        jf, of = pathlib.Path(tmp, "job.json"), pathlib.Path(tmp, "out.json")
        jf.write_text(json.dumps([{"task": "cells",
                                   "cells": [list(c) for c in cells],
                                   "mesh": list(mesh), "remat": remat}]))
        env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"))
        subprocess.run([sys.executable, str(HERE / "torch_ref_mesh.py"),
                        str(jf), str(of)], check=True, timeout=600, env=env)
        return {tuple(r["cell"]): r for r in json.loads(of.read_text())[0]}


@pytest.fixture(scope="module")
def xla():
    return xla_cells(CELLS)


@pytest.fixture(scope="module", params=CELLS, ids=lambda c: ".".join(c))
def cell(request):
    arch, shape, variant = request.param
    rec = dryrun.run_cell(arch, shape, variant=variant, mesh_shape=MESH,
                          write=False)
    assert "error" not in rec, rec.get("traceback")
    return request.param, rec


def test_argument_bytes_equal_xla(xla, cell):
    key, rec = cell
    assert rec["memory"]["argument_bytes"] == xla[key]["argument_bytes"]


def flops_ratios(rec, ref) -> tuple:
    """(port / XLA dot FLOPs, port / XLA total FLOPs), printed."""
    f = rec["hlo_costs"]["flops"]
    r_dot, r_all = f / ref["dot_flops"], f / ref["flops"]
    print(f"{ref['cell']}: port {f:.4g} FLOPs a rank; XLA dots "
          f"{ref['dot_flops']:.4g} (ratio {r_dot:.3f}), XLA total "
          f"{ref['flops']:.4g} with fused elementwise output bytes "
          f"(ratio {r_all:.3f})")
    return r_dot, r_all


def test_flops_within_1p5x_of_xla_dots(xla, cell):
    key, rec = cell
    r_dot, _ = flops_ratios(rec, xla[key])
    if key[1] == "prefill_32k":
        # both attend every (query, key) pair of the prompt: the port's
        # plain flash version masks after the product, as XLA does
        print("  prefill: neither skips masked blocks")
    assert 1 / 1.5 <= r_dot <= 1.5


def xla_peak(ref) -> int:
    return ref["argument_bytes"] + ref["temp_bytes"]


def test_peak_against_xla_argument_and_temp_bytes(xla, cell):
    key, rec = cell
    ref = xla[key]
    mem = rec["memory"]
    print(f"{key}: port peak {mem['peak_bytes']:.4g} B a rank (temp "
          f"{mem['temp_bytes']:.4g}); XLA argument + temp "
          f"{xla_peak(ref):.4g} (temp {ref['temp_bytes']:.4g}); ratio "
          f"{mem['peak_bytes'] / xla_peak(ref):.3f}")
    if key[1] == "prefill_32k":
        assert 1 / 1.5 <= mem["peak_bytes"] / xla_peak(ref) <= 1.5
    else:
        assert mem["temp_bytes"] <= ref["temp_bytes"]


def test_flops_and_bytes_halve_with_the_data_axis():
    """llama3.2-1b x prefill_32k x fsdp (32 prompts) on (2, 2) and (4, 2):
    16 then 8 prompts a rank. Each rank's FLOPs halve (within 5%), as
    XLA's dot FLOPs do; argument bytes equal XLA's on both meshes and
    halve with the ZeRO-3 weights and the cache; the peak falls by over a
    third, and stays within 1.5x of XLA's argument + temp bytes."""
    key = ("llama3.2-1b", "prefill_32k", "fsdp")
    port, ref = {}, {}
    for m in ((2, 2), (4, 2)):
        port[m] = dryrun.run_cell(*key[:2], variant=key[2], write=False,
                                  mesh_shape=MeshShape(("data", "model"), m))
        assert "error" not in port[m], port[m].get("traceback")
        ref[m] = xla_cells([key], mesh=m)[key]
        assert port[m]["memory"]["argument_bytes"] == \
            ref[m]["argument_bytes"]
        r = port[m]["memory"]["peak_bytes"] / xla_peak(ref[m])
        print(f"{m}: port FLOPs {port[m]['hlo_costs']['flops']:.4g}, peak "
              f"{port[m]['memory']['peak_bytes']:.4g} ({r:.3f} of XLA's "
              f"argument + temp); XLA dots {ref[m]['dot_flops']:.4g}")
        assert 1 / 1.5 <= r <= 1.5
    a, b = port[(2, 2)], port[(4, 2)]
    assert 1.9 <= a["hlo_costs"]["flops"] / b["hlo_costs"]["flops"] <= 2.1
    assert 1.9 <= ref[(2, 2)]["dot_flops"] / ref[(4, 2)]["dot_flops"] <= 2.1
    assert b["memory"]["argument_bytes"] < 0.55 * a["memory"][
        "argument_bytes"]
    assert b["memory"]["peak_bytes"] < 0.66 * a["memory"]["peak_bytes"]


def test_records_carry_the_reference_keys(cell):
    """Every key of the reference's record but ``xla_cost_analysis``
    (no counterpart), with the same keys under memory, hlo_costs and
    roofline."""
    key, rec = cell
    for k in ("arch", "shape", "mesh", "variant", "tag", "lower_s",
              "compile_s", "devices", "memory", "hlo_costs", "roofline"):
        assert k in rec, k
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "peak_bytes"}
    assert {"flops", "bytes", "collective_bytes",
            "collective_breakdown"} <= set(rec["hlo_costs"])
    assert rec["devices"] == 8
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]
    assert rec["memory"]["temp_bytes"] == (rec["memory"]["peak_bytes"]
                                           - rec["memory"]["argument_bytes"])
    from repro.core.hlo_analysis import HloCosts
    ref_keys = set(jdryrun.roofline_terms(
        HloCosts(flops=1.0, bytes=1.0, collective_bytes=1.0),
        jget(key[0]), key[1], 8))
    assert set(rec["roofline"]) == ref_keys
    assert rec["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2.5-3b",
                                  "arctic-480b"])
def test_full_attention_long_500k_is_skipped_with_the_reference_reason(arch):
    rec = dryrun.run_cell(arch, "long_500k", mesh_shape=MESH, write=False)
    assert rec["skipped"] == jcell_runnable(jget(arch), "long_500k")
    assert "error" not in rec and "memory" not in rec


def test_cli_refuses_the_reference_tiling_flags():
    for flag in dryrun.REFUSED_FLAGS:
        with pytest.raises(SystemExit):
            dryrun.main(["--arch", "llama3.2-1b", flag, "1"])


def test_extractor_counts_a_dtensor_all_gather_at_local_shapes():
    """Under the fake group of 8 ranks: all-gathering a (16, 8) f32 DTensor
    sharded 4 ways over "model" is one all-gather of its 512-byte result;
    a product of shards counts the local product's FLOPs only."""
    with fake_process_group(8):
        mesh = mesh_over(MESH)
        with FakeTensorMode():
            x = DTensor.from_local(torch.empty(4, 8), mesh,
                                   [Replicate(), Shard(0)], run_check=False)
            c = analyze(lambda: x.redistribute(mesh, [Replicate()] * 2))
            assert c.collective_counts == {"all-gather": 16 * 8 * 4}
            assert c.collective_bytes == 16 * 8 * 4
            w = DTensor.from_local(torch.empty(8, 6), mesh,
                                   [Replicate(), Replicate()],
                                   run_check=False)
            c = analyze(lambda: x @ w)
            assert c.flops == 2 * 4 * 8 * 6 and c.collective_bytes == 0
