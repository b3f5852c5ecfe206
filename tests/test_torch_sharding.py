"""The port's sharding rules (``repro_torch.sharding``) and the dry run's
cell table (``models.api``: ``SHAPES``, ``cell_runnable``,
``input_specs``) against the reference's, and ``placements()`` against
``NamedSharding``'s layout.

The reference's rules read ``jax.eval_shape`` trees on a duck-typed mesh
(as ``tests/test_distribution.py`` does); the port's read the port's own
params and cache trees, made under ``FakeTensorMode`` (shapes, no data,
no draws), on a ``launch.mesh.MeshShape``. Every leaf's spec must be
equal, for the 12 configs on both production meshes in both modes. A
dim split over ("pod", "data") must put the same rows on the same mesh
coordinate as ``NamedSharding`` (the reference's side runs in a
subprocess with 8 host devices: ``torch_ref_mesh.py``)."""
import json
import pathlib
import subprocess
import sys
import tempfile

import jax
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Shard

from repro.configs import ASSIGNED_ARCHS, PAPER_ARCHS
from repro.configs import get_config as jget
from repro.models import SHAPES as JSHAPES
from repro.models import RuntimeOptions as JOpts
from repro.models import cell_runnable as jcell_runnable
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import input_specs as jinput_specs
from repro.sharding import rules as jrules
import repro_torch.models as tm
from repro_torch.configs import get_config
from repro_torch.launch.mesh import MeshShape, production_shape
from repro_torch.sharding import rules

torch.set_num_threads(2)

ARCHS = list(ASSIGNED_ARCHS) + list(PAPER_ARCHS)
MESHES = {"16x16": False, "2x16x16": True}
HERE = pathlib.Path(__file__).resolve().parent


class FakeMesh:
    """Duck-typed mesh of the reference's rules: only .shape is read."""
    def __init__(self, shape: MeshShape):
        self.shape = dict(zip(shape.mesh_dim_names, shape.shape))


def _norm(spec) -> tuple:
    """A spec as a tuple, a one-axis tuple entry as its name (JAX's
    PartitionSpec stores ("data",) as "data": the same layout)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _flat_j(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]:
        out[jrules._path_str(path)] = _norm(leaf)
    return out


def _flat_t(tree):
    return {rules._path_str(p): _norm(s) for p, s in rules.spec_items(tree)}


@pytest.fixture(scope="module")
def trees():
    """arch -> (reference params shapes, port params (fake), reference
    decode_32k cache shapes, port cache (fake))."""
    out = {}
    sp = JSHAPES["decode_32k"]
    L = ((sp.seq_len + 8 + 255) // 256) * 256
    for arch in ARCHS:
        jcfg, cfg = jget(arch), get_config(arch)
        jp = jax.eval_shape(lambda: jinit_params(jcfg, jax.random.PRNGKey(0),
                                                 JOpts()))
        jc = jax.eval_shape(lambda: jinit_cache(jcfg, sp.global_batch, L,
                                                JOpts()))
        with FakeTensorMode():
            tp = tm.init_params(cfg, torch.Generator(), "bfloat16", "cpu")
            tc = tm.init_cache(cfg, sp.global_batch, L, tm.RuntimeOptions(),
                               "cpu")
        out[arch] = (jp, tp, jc, tc)
    return out


@pytest.mark.parametrize("mode", ["fsdp", "tp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_state_specs_equal_reference(trees, arch, mesh, mode):
    """param_pspecs and opt_state_pspec (ZeRO-1) leaf by leaf: same paths,
    same specs (exact)."""
    jp, tp, _, _ = trees[arch]
    shp = production_shape(multi_pod=MESHES[mesh])
    js = jrules.param_pspecs(jget(arch), jp, FakeMesh(shp), mode=mode)
    ts = rules.param_pspecs(get_config(arch), tp, shp, mode=mode)
    jf, tf = _flat_j(js), _flat_t(ts)
    assert jf == tf
    ts_flat = {rules._path_str(p): s for p, s in rules.spec_items(ts)}
    jshape = {jrules._path_str(p): leaf.shape for p, leaf in
              jax.tree_util.tree_flatten_with_path(jp)[0]}
    for path, spec in tf.items():
        want = tuple(jrules.opt_state_pspec(
            jax.sharding.PartitionSpec(*jf[path]), jshape[path],
            FakeMesh(shp)))
        assert _norm(rules.opt_state_pspec(rules.P(*ts_flat[path]),
                                           jshape[path], shp)) == \
            _norm(want), path


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_reference(trees, arch, mesh):
    """cache_pspecs of the decode_32k cache (heads over "model" when they
    divide, else the length), leaf by leaf, and paged_cache_pspecs of a
    pool of the same leaves."""
    _, _, jc, tc = trees[arch]
    shp = production_shape(multi_pod=MESHES[mesh])
    B = JSHAPES["decode_32k"].global_batch
    assert _flat_t(rules.cache_pspecs(get_config(arch), tc, shp, B)) == \
        _flat_j(jrules.cache_pspecs(jget(arch), jc, FakeMesh(shp), B))
    assert _flat_t(rules.paged_cache_pspecs(tc, shp)) == \
        _flat_j(jrules.paged_cache_pspecs(jc, FakeMesh(shp)))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("mesh", ["16x16", "2x16x16", "1x4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_data_specs_and_batch_axes_equal_reference(arch, mesh, kind):
    shp = (MeshShape(("data", "model"), (1, 4)) if mesh == "1x4"
           else production_shape(multi_pod=MESHES[mesh]))
    fm = FakeMesh(shp)
    for gb in (0, 1, 32, 256):
        got = {k: _norm(v) for k, v in
               rules.data_pspecs(get_config(arch), shp, kind, gb).items()}
        want = {k: _norm(v) for k, v in
                jrules.data_pspecs(jget(arch), fm, kind, gb).items()}
        assert got == want
        assert rules.effective_batch_axes(shp, gb) == \
            jrules.effective_batch_axes(fm, gb)
    assert rules.batch_axes(shp) == jrules.batch_axes(fm)


@pytest.mark.parametrize("shape", list(JSHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_cells_and_input_specs_equal_reference(arch, shape):
    """The four shape cells, each config's skip reason, and every input
    stand-in's shape and dtype (meta tensors against ShapeDtypeStructs)."""
    sp, jsp = tm.SHAPES[shape], JSHAPES[shape]
    assert (sp.name, sp.seq_len, sp.global_batch, sp.kind) == \
        (jsp.name, jsp.seq_len, jsp.global_batch, jsp.kind)
    cfg, jcfg = get_config(arch), jget(arch)
    assert tm.cell_runnable(cfg, shape) == jcell_runnable(jcfg, shape)
    got = tm.input_specs(cfg, shape)
    want = jinput_specs(jcfg, shape)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == tuple(want[k].shape), k
        assert str(v.dtype).split(".")[-1] == str(want[k].dtype), k
    assert list(tm.SHAPES) == list(JSHAPES)


ROW_CASES = [  # (mesh, names, global shape, spec)
    ((2, 2, 2), ("pod", "data", "model"), (8, 6), (("pod", "data"), None)),
    ((2, 2, 2), ("pod", "data", "model"), (4, 8, 12),
     (None, ("pod", "data"), "model")),
    ((2, 4), ("data", "model"), (8, 16), ("data", "model")),
]


@pytest.fixture(scope="module")
def ref_rows():
    job = [{"task": "rows", "mesh": list(m), "names": list(n),
            "shape": list(s), "spec": [list(e) if isinstance(e, tuple)
                                       else e for e in spec]}
           for m, n, s, spec in ROW_CASES]
    with tempfile.TemporaryDirectory() as tmp:
        jf, of = pathlib.Path(tmp, "job.json"), pathlib.Path(tmp, "out.json")
        jf.write_text(json.dumps(job))
        subprocess.run([sys.executable, str(HERE / "torch_ref_mesh.py"),
                        str(jf), str(of)], check=True, timeout=300,
                       env=_env())
        return json.loads(of.read_text())


def _env():
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = str(HERE.parent / "src")
    return env


@pytest.mark.parametrize("case", range(len(ROW_CASES)))
def test_placements_hold_namedsharding_rows(ref_rows, case):
    """For every mesh coordinate, the rows (offset and length on each dim)
    DTensor gives that rank under ``placements(spec)`` are the slice
    ``NamedSharding(mesh, P(*spec))`` puts on the device at that
    coordinate; rank 0's local shape is ``shard_shape``."""
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset
    mesh_shape, names, shape, spec = ROW_CASES[case]
    shp = MeshShape(names, mesh_shape)
    pl = rules.placements(rules.P(*spec), shp)
    want = ref_rows[case]
    for entry in want["rows"]:
        local, offset = _compute_local_shape_and_global_offset(
            shape, mesh_shape, entry["coord"], pl)
        got = [[o, o + n] for o, n in zip(offset, local)]
        assert got == entry["slices"], entry["coord"]
    local, _ = _compute_local_shape_and_global_offset(
        shape, mesh_shape, [0] * len(mesh_shape), pl)
    assert list(local) == want["shard_shape"]


def test_placements_refuse_an_order_against_the_mesh():
    shp = MeshShape(("pod", "data", "model"), (2, 2, 2))
    assert rules.placements(rules.P(("pod", "data")), shp) == (
        Shard(0), Shard(0), rules.Replicate())
    with pytest.raises(NotImplementedError, match="order"):
        rules.placements(rules.P(("data", "pod")), shp)


def _merged(spec) -> tuple:
    """A spec of the three-axis mesh on the dry run's batch-flattened one:
    ("pod", "data") becomes "data"."""
    return tuple("data" if e == ("pod", "data") else e for e in spec)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_flattened_mesh_gives_each_rank_the_same_shard(trees, arch):
    """The dry run lays its DTensors out on ``batch_flattened`` (2, 16, 16):
    a (32, 16) ("data", "model") mesh. The rules never split a dim over
    "pod" or "data" alone there, so every parameter, optimizer-state,
    cache and input spec is the three-axis spec with ("pod", "data") read
    as "data"; and on a (2, 2, 2) mesh every coordinate (p, d, m) holds
    the rows that (2p + d, m) holds on the flattened (4, 2) one."""
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset
    from repro_torch.launch.dryrun import batch_flattened
    _, tp, _, tc = trees[arch]
    cfg, shp = get_config(arch), production_shape(multi_pod=True)
    flat = batch_flattened(shp)
    assert flat == MeshShape(("data", "model"), (32, 16))
    for mode in ("fsdp", "tp"):
        three = _flat_t(rules.param_pspecs(cfg, tp, shp, mode=mode))
        two = _flat_t(rules.param_pspecs(cfg, tp, flat, mode=mode))
        assert {k: _merged(v) for k, v in three.items()} == two
    B = JSHAPES["decode_32k"].global_batch
    assert {k: _merged(v) for k, v in _flat_t(
        rules.cache_pspecs(cfg, tc, shp, B)).items()} == \
        _flat_t(rules.cache_pspecs(cfg, tc, flat, B))
    for kind in ("train", "prefill", "decode"):
        for gb in (1, 32, 256):
            assert {k: _merged(_norm(v)) for k, v in rules.data_pspecs(
                cfg, shp, kind, gb).items()} == \
                {k: _norm(v) for k, v in rules.data_pspecs(
                    cfg, flat, kind, gb).items()}
    small = MeshShape(("pod", "data", "model"), (2, 2, 2))
    small_flat = batch_flattened(small)
    for spec, shape in (((("pod", "data"), None), (8, 6)),
                        ((None, ("pod", "data"), "model"), (4, 8, 12))):
        pl3 = rules.placements(rules.P(*spec), small)
        pl2 = rules.placements(rules.P(*_merged(spec)), small_flat)
        for p in range(2):
            for d in range(2):
                for m in range(2):
                    assert _compute_local_shape_and_global_offset(
                        shape, (2, 2, 2), [p, d, m], pl3) == \
                        _compute_local_shape_and_global_offset(
                            shape, (4, 2), [2 * p + d, m], pl2)
