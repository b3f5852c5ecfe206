"""The port's dry run of a train cell against the reference's compiled
one (see ``test_torch_dryrun.py``): qwen2.5-3b x train_4k x fsdp on a
(2, 4) mesh with ``remat="block"`` (the dry run's CLI default, as the
reference's), whose step is 32 micro-batches of 4 sequences (the local
batch of 128 over ``max(1, 128 // 4)``), gradients accumulated in f32,
then AdamW on ZeRO-1 state. Rank 0's argument bytes (params, the f32
moments and master copies, the batch) equal XLA's
``argument_size_in_bytes`` exactly; the FLOPs, one micro-batch traced
and counted 32 times plus the update, are within 1.5x either way of the
compiled HLO's dot FLOPs (both recompute each layer's forward); and the
peak, one micro-batch's layer inputs plus one layer recomputed beside
the state, is within 1.5x either way of XLA's argument + temp bytes."""
import pytest
import torch

from repro_torch.launch import dryrun
from repro_torch.models import RuntimeOptions

from test_torch_dryrun import MESH, flops_ratios, xla_cells, xla_peak

torch.set_num_threads(2)

CELL = ("qwen2.5-3b", "train_4k", "fsdp")


@pytest.fixture(scope="module")
def both():
    rec = dryrun.run_cell(*CELL[:2], variant=CELL[2], mesh_shape=MESH,
                          opts=RuntimeOptions(remat="block"), write=False)
    assert "error" not in rec, rec.get("traceback")
    return rec, xla_cells([CELL], remat="block")[CELL]


def test_train_argument_bytes_equal_xla(both):
    rec, ref = both
    assert rec["n_micro"] == 32
    assert rec["memory"]["argument_bytes"] == ref["argument_bytes"]


def test_train_flops_within_1p5x_of_xla_dots(both):
    rec, ref = both
    r_dot, _ = flops_ratios(rec, ref)
    assert 1 / 1.5 <= r_dot <= 1.5


def test_train_peak_within_1p5x_of_xla_argument_and_temp(both):
    rec, ref = both
    r = rec["memory"]["peak_bytes"] / xla_peak(ref)
    print(f"{CELL}: port peak {rec['memory']['peak_bytes']:.4g} B a rank; "
          f"XLA argument + temp {xla_peak(ref):.4g}; ratio {r:.3f}")
    assert 1 / 1.5 <= r <= 1.5
