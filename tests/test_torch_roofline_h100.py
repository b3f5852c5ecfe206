"""``repro_torch.paper.roofline_h100`` (the reference's
``benchmarks/roofline_tpu.py`` on the H100) over dry-run records that the
test writes: one row per priced cell, its three terms those of
``core.h100_roofline.terms_from_costs`` on the record's costs; skipped,
failed and tagged records give no row; no records, one row saying so."""
import json

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import h100_roofline as hr
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import SHAPES
from repro_torch.paper import roofline_h100

torch.set_num_threads(2)

MESH = MeshShape(("data", "model"), (1, 2))


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    art = tmp_path_factory.mktemp("dryrun_torch")
    saved = dryrun.ART
    dryrun.ART = art
    try:
        dryrun.run_cell("mamba2-130m", "decode_32k", mesh_shape=MESH)
        dryrun.run_cell("mamba2-130m", "long_500k", mesh_shape=MESH)
        dryrun.run_cell("llama3.2-1b", "long_500k", mesh_shape=MESH)
        dryrun.run_cell("mamba2-130m", "decode_32k", mesh_shape=MESH,
                        tag="variant")
    finally:
        dryrun.ART = saved
    return art


def _rows(art):
    rows = []
    derived = roofline_h100.run(lambda n, us, d: rows.append((n, d)), art)
    return rows, derived


def test_one_row_a_priced_cell(records):
    rows, derived = _rows(records)
    assert [n for n, _ in rows] == [
        "roofline.mamba2-130m.decode_32k.pod1x2.fsdp",
        "roofline.mamba2-130m.long_500k.pod1x2.fsdp"]
    assert derived.startswith("2 cells;")
    assert (records / "llama3.2-1b.long_500k.pod1x2.fsdp.json").exists()


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_row_terms_are_the_h100_roofline_of_the_record(records, shape):
    rec = json.loads((records / f"mamba2-130m.{shape}.pod1x2.fsdp.json")
                     .read_text())
    c = rec["hlo_costs"]
    sp = SHAPES[shape]

    class Costs:
        flops, bytes, collective_bytes = (c["flops"], c["bytes"],
                                          c["collective_bytes"])
    t = hr.terms_from_costs(Costs, n_dev=2, model_flops=hr.model_flops_for(
        get_config("mamba2-130m"), sp.kind, sp.seq_len, sp.global_batch))
    assert rec["roofline"]["compute_s"] == pytest.approx(t.compute_s,
                                                         rel=1e-12)
    assert rec["roofline"]["bottleneck"] == t.bottleneck
    row = dict(_rows(records)[0])[f"roofline.mamba2-130m.{shape}.pod1x2.fsdp"]
    assert f"compute={t.compute_s:.2e}s" in row
    assert f"memory={t.memory_s:.2e}s" in row
    assert f"bott={t.bottleneck}" in row
    assert f"bound={t.step_lower_bound_s:.2e}s" in row


def test_no_records_one_row(tmp_path, capsys):
    rows, derived = _rows(tmp_path / "absent")
    assert rows == [] and "no dry-run records" in derived
    roofline_h100.main(["--art", str(tmp_path / "absent")])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert out[1].startswith("roofline_h100.total,0.0,no dry-run records")


def test_markdown_table_rows(records, capsys):
    """--markdown: a row a record, untagged: the priced cells with their
    bytes and bound, the skipped one with the reference's reason."""
    roofline_h100.main(["--art", str(records), "--markdown"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 + 3
    rec = json.loads((records / "mamba2-130m.decode_32k.pod1x2.fsdp.json")
                     .read_text())
    row = next(r for r in out if "decode_32k" in r)
    assert f"{rec['memory']['argument_bytes'] / 1e9:.3f}" in row
    assert rec["roofline"]["bottleneck"] in row
    assert any("full-attention KV at 500k" in r for r in out)


def test_grid_of_the_production_meshes(tmp_path, capsys):
    """--grid: a row an arch, a column a shape; a cell gives the peak GB,
    bottleneck and bound of both production meshes, "skipped" where both
    are skipped, "missing" where a mesh's record is absent."""
    for mesh, peak in (("pod16x16", 2e9), ("pod2x16x16", 1e9)):
        (tmp_path / f"a.decode_32k.{mesh}.fsdp.json").write_text(json.dumps(
            {"arch": "a", "shape": "decode_32k", "mesh": mesh, "tag": "",
             "memory": {"peak_bytes": peak},
             "roofline": {"bottleneck": "memory",
                          "step_time_lower_bound_s": peak / 1e12}}))
        (tmp_path / f"a.long_500k.{mesh}.fsdp.json").write_text(json.dumps(
            {"arch": "a", "shape": "long_500k", "mesh": mesh, "tag": "",
             "skipped": "why"}))
    (tmp_path / "b.decode_32k.pod16x16.fsdp.json").write_text(json.dumps(
        {"arch": "b", "shape": "decode_32k", "mesh": "pod16x16", "tag": "",
         "skipped": "why"}))
    roofline_h100.main(["--art", str(tmp_path), "--grid"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "| arch | decode_32k | long_500k |"
    assert out[2] == "| a | 2 / 1 GB; mem; 0.002 / 0.001 s | skipped |"
    assert out[3] == "| b | missing | missing |"
