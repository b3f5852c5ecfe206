"""The port's model layer (repro_torch.models) against the reference
(repro.models, attn_impl="xla") on the same weights and inputs.

Per-op checks, the numpy weight bridge, and the paged model path —
chunked prefill, one decode step, the fused K-step greedy block — on the
reduced llama3.2-1b twin (MHA) and its GQA twin (group 4), with native f32
and int8 KV pools. Also an import scan that keeps JAX and the reference
package out of the port."""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.reduce import reduced
from repro.models import RuntimeOptions
from repro.models import common as jcm
from repro.models import lm as jlm
from repro.models import moe as jmoe
import repro_torch.models as tm
from repro_torch.configs import get_config as tget
from repro_torch.configs.reduce import reduced as treduced
from repro_torch.models import common as tcm
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
OP_TOL = dict(atol=1e-6, rtol=1e-6)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------- per op --------------------------------- #

def test_dense_matches():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32), dtype=np.float32)
    p = {"w": rng.standard_normal((32, 48), dtype=np.float32),
         "b": rng.standard_normal((48,), dtype=np.float32)}
    want = jcm.dense(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    got = tcm.dense({k: _t(v) for k, v in p.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


def test_rms_norm_matches():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, 64), dtype=np.float32) * 3
    w = rng.standard_normal((64,), dtype=np.float32) * 0.1
    want = jcm.rms_norm(jnp.asarray(x), jnp.asarray(w))
    got = tcm.rms_norm(_t(x), _t(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


@pytest.mark.parametrize("hd", [16, 64])
def test_apply_rope_matches(hd):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 4, hd), dtype=np.float32)
    pos = rng.integers(0, 500, size=(2, 6)).astype(np.int32)
    want = jcm.apply_rope(jnp.asarray(x), jnp.asarray(pos))
    got = tcm.apply_rope(_t(x), _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)
    np.testing.assert_allclose(tcm.rope_freqs(hd).numpy(),
                               np.asarray(jcm.rope_freqs(hd)), **OP_TOL)


@pytest.mark.parametrize("gated", [True, False])
def test_dense_ffn_matches(gated):
    rng = np.random.default_rng(3)
    cfg = reduced(get_config("llama3.2-1b"), d_model=32).replace(
        gated_mlp=gated)
    p = _np(jmoe.init_dense_ffn(jax.random.PRNGKey(0), cfg, 64, jnp.float32))
    x = rng.standard_normal((2, 3, 32), dtype=np.float32)
    want = jmoe.dense_ffn(jax.tree_util.tree_map(jnp.asarray, p),
                          jnp.asarray(x), gated)
    got = tmoe.dense_ffn(tm.params_from_numpy(p, device="cpu"), _t(x), gated)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


def test_params_from_numpy_round_trip():
    cfg = reduced(get_config("llama3.2-1b"), d_model=64, n_layers=2,
                  vocab=128)
    jp = _np(jlm.init_params(cfg, jax.random.PRNGKey(0),
                             RuntimeOptions(dtype="float32")))
    tp = tm.params_from_numpy(jp, device="cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: t.numpy(), tp)))
    for path, leaf in flat_j:
        node = tp
        for k in path:
            node = node[k.key]
        assert node.dtype == torch.float32 and tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), leaf)
    assert tp["stack"]["attn"]["wq"]["w"].shape[0] == cfg.n_layers
    bf = tm.params_from_numpy(jp, device="cpu", dtype="bfloat16")
    assert bf["embed"]["emb"].dtype == torch.bfloat16
    # bf16 reference weights (ml_dtypes arrays) keep their exact values
    jb = _np(jlm.init_params(cfg, jax.random.PRNGKey(0),
                             RuntimeOptions(dtype="bfloat16")))
    tb = tm.params_from_numpy(jb, device="cpu")
    w = tb["stack"]["mlp"]["up"]["w"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.float().numpy(), jb["stack"]["mlp"]["up"]["w"].astype(np.float32))


def test_init_params_layout_matches_reference():
    """The port's own seeded init has the reference's tree, shapes and
    dtype, and one seed gives one set of weights."""
    cfg = reduced(get_config("llama3.2-1b"), d_model=64, n_layers=2,
                  vocab=128)
    tcfg = treduced(tget("llama3.2-1b"), d_model=64, n_layers=2, vocab=128)
    jp = jax.eval_shape(lambda: jlm.init_params(
        cfg, jax.random.PRNGKey(0), RuntimeOptions(dtype="bfloat16")))

    def init(seed):
        return tlm.init_params(tcfg, torch.Generator().manual_seed(seed),
                               "bfloat16", "cpu")
    a, b = init(0), init(0)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        na, nb = a, b
        for k in path:
            na, nb = na[k.key], nb[k.key]
        assert tuple(na.shape) == leaf.shape and na.dtype == torch.bfloat16
        assert torch.equal(na, nb)
    assert not torch.equal(init(1)["embed"]["emb"], a["embed"]["emb"])


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = treduced(tget("llama3.2-1b"), d_model=64, n_layers=2, vocab=128)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlm.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        tlm.init_paged_cache(cfg, 4, 4)


def test_paged_supported_rejects_off_path_families():
    assert tlm.paged_supported(tget("llama3.2-1b")) is None
    assert tlm.paged_supported(tget("llama3.2-1b-gqa")) is None
    assert tlm.paged_supported(tget("arctic-480b")) is None      # MoE
    # the reference's reasons (lm.paged_supported; models.paged_supported
    # answers for the modules without a paged path)
    for arch, reason in [
            ("deepseek-v2-236b",
             "MLA latent cache is already compressed; paged path covers GQA"),
            ("mamba2-130m",
             "family 'ssm' is not covered by the paged KV path"),
            ("whisper-medium",
             "family 'encdec' is not covered by the paged KV path")]:
        assert tlm.paged_supported(tget(arch)) == reason, arch
    assert tm.paged_supported(tget("whisper-medium")) == (
        "family 'encdec' has no paged serving path")


# --------------------------- paged model path --------------------------- #

ARCHS = ["llama3.2-1b", "llama3.2-1b-gqa"]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    cfg = reduced(get_config(arch), d_model=64, n_layers=2, vocab=128)
    tcfg = treduced(tget(arch), d_model=64, n_layers=2, vocab=128)
    jp = jlm.init_params(cfg, jax.random.PRNGKey(0),
                         RuntimeOptions(dtype="float32"))
    tp = tm.params_from_numpy(_np(jp), device="cpu")
    return cfg, tcfg, jp, tp


def _opts(cache_dtype):
    return (RuntimeOptions(dtype="float32", cache_dtype=cache_dtype),
            tlm.RuntimeOptions(dtype="float32", cache_dtype=cache_dtype))


def _assert_pool(tcache, jcache):
    for name, arr in jcache["stack"].items():
        got = tcache["stack"][name]
        if arr.dtype == jnp.int8:
            np.testing.assert_array_equal(got.numpy(), np.asarray(arr),
                                          err_msg=name)
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(arr),
                                       **MODEL_TOL, err_msg=name)


_JAX_PREFILL = {}


def _prefill_both(cfg, tcfg, jp, tp, cache_dtype, *, C=8, ps=4, npp=6):
    """Two chunks of a ragged 2-sequence batch through both packages. The
    reference's (immutable) result is computed once per model and pool
    type; the port's pool is updated in place, so it is built fresh."""
    jo, to = _opts(cache_dtype)
    B, P = 2, 2 * npp + 1
    rng = np.random.default_rng(7)
    pt = (rng.permutation(P - 1)[:B * npp].reshape(B, npp) + 1).astype(
        np.int32)
    lens = np.asarray([13, 10], np.int32)
    toks = np.zeros((B, 16), np.int32)
    for b in range(B):
        toks[b, :lens[b]] = rng.integers(1, cfg.vocab, size=lens[b])
    key = (cfg.name, cfg.n_kv_heads, cache_dtype)
    if key not in _JAX_PREFILL:
        jc = jlm.init_paged_cache(cfg, P, ps, jo)
        jls = []
        for ci, start in enumerate((0, C)):
            nv = np.minimum(lens, start + C).astype(np.int32)
            jl, jc = jlm.prefill_paged_chunk(
                cfg, jp, jnp.asarray(toks[:, start:start + C]), jc,
                jnp.asarray(pt), jnp.int32(start), jnp.asarray(nv), jo,
                calibrate=(ci == 0 and cache_dtype == "int8"))
            jls.append(np.asarray(jl))
        _JAX_PREFILL[key] = (jc, jls)
    jc, jls = _JAX_PREFILL[key]
    tc = tlm.init_paged_cache(tcfg, P, ps, to, device="cpu")
    outs = []
    for ci, start in enumerate((0, C)):
        nv = np.minimum(lens, start + C).astype(np.int32)
        tl, tc = tlm.prefill_paged_chunk(
            tcfg, tp, _t(toks[:, start:start + C]), tc, _t(pt), start,
            _t(nv), to, calibrate=(ci == 0 and cache_dtype == "int8"))
        outs.append((jls[ci], tl.numpy(), nv))
    return jc, tc, pt, lens, outs


@pytest.mark.parametrize("cache_dtype", ["", "int8"])
def test_prefill_paged_chunk_matches(model, cache_dtype):
    cfg, tcfg, jp, tp = model
    jc, tc, _, _, outs = _prefill_both(cfg, tcfg, jp, tp, cache_dtype)
    for jl, tl, nv in outs:
        np.testing.assert_allclose(tl, jl, **MODEL_TOL)
    _assert_pool(tc, jc)


@pytest.mark.parametrize("cache_dtype", ["", "int8"])
def test_decode_step_paged_matches(model, cache_dtype):
    cfg, tcfg, jp, tp = model
    jo, to = _opts(cache_dtype)
    jc, tc, pt, lens, _ = _prefill_both(cfg, tcfg, jp, tp, cache_dtype)
    tok = np.asarray([5, 77], np.int32)
    # slot 1 inactive: zero table row, length 0 (writes the null page)
    pt1 = pt.copy()
    pt1[1] = 0
    lens1 = np.asarray([lens[0], 0], np.int32)
    jl, jc = jlm.decode_step_paged(cfg, jp, jnp.asarray(tok),
                                   jnp.asarray(lens1), jnp.asarray(pt1), jc,
                                   jo)
    tl, tc = tlm.decode_step_paged(tcfg, tp, _t(tok), _t(lens1), _t(pt1), tc,
                                   to)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    _assert_pool(tc, jc)


def _first_near_tie(logits_steps, gap=1e-4):
    """Index of the first step whose top-2 logit gap is below ``gap`` in
    any row (len when none): identity is asserted up to there."""
    for i, lg in enumerate(logits_steps):
        top2 = np.sort(lg, axis=-1)[:, -2:]
        if (top2[:, 1] - top2[:, 0]).min() < gap:
            return i
    return len(logits_steps)


@pytest.mark.parametrize("cache_dtype", ["", "int8"])
def test_decode_steps_paged_token_identical(model, cache_dtype):
    cfg, tcfg, jp, tp = model
    jo, to = _opts(cache_dtype)
    jc, tc, pt, lens, outs = _prefill_both(cfg, tcfg, jp, tp, cache_dtype)
    jl_last = outs[-1][0]
    tok0 = np.asarray([np.argmax(jl_last[b, lens[b] - 8 - 1])
                       for b in range(2)], np.int32)
    K = 6
    quota = np.asarray([K, 3], np.int32)         # slot 1 latches after 3
    fused = jax.jit(lambda *a, **k: jlm.decode_steps_paged(
        cfg, jp, *a, K, jo, **k))
    jt, jc = fused(jnp.asarray(tok0), jnp.asarray(lens), jnp.asarray(pt), jc,
                   quota=jnp.asarray(quota))
    tt, tc = tlm.decode_steps_paged(tcfg, tp, _t(tok0), _t(lens), _t(pt), tc,
                                    K, to, quota=_t(quota))
    assert tt.dtype == torch.int32 and tt.shape == (2, K)
    jt = np.asarray(jt)
    # the reference's per-step logits decide where a near-tie could flip
    # argmax between two correct implementations
    jc2 = _prefill_both(cfg, tcfg, jp, tp, cache_dtype)[0]
    step = jax.jit(lambda *a: jlm.decode_step_paged(cfg, jp, *a, jo))
    steps, tok, ln = [], jnp.asarray(tok0), jnp.asarray(lens)
    for i in range(K):
        lg, jc2 = step(tok, ln, jnp.asarray(pt), jc2)
        steps.append(np.asarray(lg))
        tok, ln = jnp.asarray(jt[:, i]), ln + 1
    n = _first_near_tie(steps)
    np.testing.assert_array_equal(tt.numpy()[:, :n], jt[:, :n])
    assert (tt.numpy()[1, 3:] == 0).all()        # latched slot emits pads
    if n == K:
        _assert_pool(tc, jc)


def test_decode_steps_paged_eos_latch(model):
    """A slot that emits eos latches: pads after it, no further writes."""
    cfg, tcfg, jp, tp = model
    to = tlm.RuntimeOptions("float32")
    tok0 = np.asarray([3, 4], np.int32)
    _, tc, pt, lens, _ = _prefill_both(cfg, tcfg, jp, tp, "")
    free = tlm.decode_steps_paged(tcfg, tp, _t(tok0), _t(lens), _t(pt), tc,
                                  4, to)[0][0].tolist()
    eos = free[1]
    tc = _prefill_both(cfg, tcfg, jp, tp, "")[1]
    got = tlm.decode_steps_paged(tcfg, tp, _t(tok0), _t(lens), _t(pt), tc, 4,
                                 to, eos_id=eos, pad_id=-1)[0][0].tolist()
    e = free.index(eos)
    assert got[:e + 1] == free[:e + 1] and got[e + 1:] == [-1] * (3 - e)


def test_copy_pages_matches(model):
    cfg, tcfg, jp, tp = model
    jc, tc, _, _, _ = _prefill_both(cfg, tcfg, jp, tp, "")
    pairs = np.asarray([[3, 12], [5, 1], [0, 0], [0, 0]], np.int32)
    jc = jlm.copy_pages(jc, jnp.asarray(pairs))
    tc = tlm.copy_pages(tc, _t(pairs))
    _assert_pool(tc, jc)


# ---------------------------- import hygiene ----------------------------- #

def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names = [node.args[0].value]
        else:
            continue
        for n in names:
            root = n.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (
                f"{path.name}:{node.lineno} imports {n}")
