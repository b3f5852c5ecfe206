"""Per-shard attention (``models.common.per_shard``): what the dry run's
attention runs as on DTensors, each rank's shards under ``local_map``.

On real gloo ranks (spawned by ``launch.ranks.run_ranks``; their work is
``torch_ep_ranks.per_shard_attn``) over a ("data", "model") DeviceMesh,
the masked attention and the flash route's plain version on sharded q, k,
v equal the unsharded call within 1e-5 (f32): the batch split, heads split
with k's, and query heads split over a REPLICATED k whose heads do not
divide the model axis (each rank slices the kv head its query heads read).
Also: a plain tensor goes straight to the function, and the plain flash
version's blocks of query rows give the one-block result."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as flash
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import common as cm

import torch_ep_ranks as ranks

torch.set_num_threads(2)

B, S, H, HKV, DH = 2, 24, 8, 2, 16


def _arrays():
    rng = np.random.default_rng(7)
    return {"q": rng.standard_normal((B, S, H, DH)).astype(np.float32),
            "k": rng.standard_normal((B, S, HKV, DH)).astype(np.float32),
            "v": rng.standard_normal((B, S, HKV, DH)).astype(np.float32),
            "valid": np.array([S, S - 7], dtype=np.int32)}


def _whole(a):
    q, k, v = (torch.from_numpy(a[x]) for x in ("q", "k", "v"))
    return [cm.attention(q, k, v, mask_kind="causal", scale=0.25),
            cm.attention(q, k, v, mask_kind="sliding", window=5,
                         kv_valid=torch.from_numpy(a["valid"]), scale=0.25),
            flash.flash_attention(q, k, v, causal=True, scale=0.25)]


# (mesh, [(q placements, k/v placements)]): heads 8 over model 4 read a
# replicated k of 2 heads (one kv head a rank); batch over data with heads
# split alike; batch over data with query heads over a replicated k
MESHES = {"1x4": ((1, 4), [(("R", "S2"), ("R", "R"))]),
          "2x2": ((2, 2), [(("S0", "S2"), ("S0", "S2")),
                           (("S0", "S2"), ("S0", "R"))])}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_per_shard_attention_on_ranks_equals_the_whole(mesh):
    shape, cases = MESHES[mesh]
    a = _arrays()
    want = [w.numpy() for w in _whole(a)]
    outs = run_ranks(ranks.per_shard_attn, 4, (shape, a, cases),
                     backend="gloo", timeout=120)
    for rank_out in outs:
        for case in rank_out:
            for got, ref in zip(case, want):
                np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_per_shard_of_plain_tensors_is_the_function():
    calls = []

    def fn(q, k, v, **kw):
        calls.append(kw)
        return q
    q = torch.zeros(1, 2, 2, 4)
    assert cm.per_shard(fn, q, q, q, scale=0.5) is q
    assert cm.per_shard(fn, q, q, q, kv_valid=3) is q
    assert calls == [{"scale": 0.5}, {"kv_valid": 3}]


@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_in_row_blocks_equals_one_block(monkeypatch, causal):
    """At 40 x 40 with blocks of 64 rows x keys: 1 query row a block, 40
    blocks, against one block of all 40 (f32, within 1e-6)."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 40, 4, 8), np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 40, 2, 8), np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 40, 2, 8), np.float32))
    one = flash.flash_attention_plain(q, k, v, causal=causal)
    monkeypatch.setattr(flash, "_PLAIN_BLOCK", 64)
    blocked = flash.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(blocked, one, rtol=0, atol=1e-6)
