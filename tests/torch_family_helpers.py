"""Shared set-up of the port's family tests (MLA, Mamba-2, Zamba2,
Whisper): a reduced config in both packages with the reference's f32
weights in both, tree leaves in the reference's order, and a reference
and a port static engine over the same weights."""
import jax
import numpy as np

import repro_torch.models as tm
from repro.configs import get_config
from repro.configs.reduce import reduced
from repro.models import RuntimeOptions
from repro.models import api as japi
from repro.serving import ServeEngine as JaxEngine
from repro_torch.configs import get_config as tget
from repro_torch.configs.reduce import reduced as treduced
from repro_torch.serving import ServeEngine

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=1e-5, rtol=1e-5)
COUNTERS = ("host_syncs", "decode_steps", "decode_compiles", "new_tokens",
            "requests")


def family_model(arch: str, seed: int = 0, **reduce_kw):
    """(cfg, tcfg, reference params, port params): ``arch`` reduced to
    d_model 64 and vocab 128 in both packages, the reference's seeded f32
    weights converted for the port."""
    kw = dict(d_model=64, vocab=128, **reduce_kw)
    cfg = reduced(get_config(arch), **kw)
    tcfg = treduced(tget(arch), **kw)
    jp = japi.init_params(cfg, jax.random.PRNGKey(seed),
                          RuntimeOptions(dtype="float32"))
    tp = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return cfg, tcfg, jp, tp


def opts(cache_dtype: str = "", **kw):
    """The f32 options of both packages."""
    return (RuntimeOptions(dtype="float32", cache_dtype=cache_dtype, **kw),
            tm.RuntimeOptions(dtype="float32", cache_dtype=cache_dtype,
                              **kw))


def leaves(tree):
    """Tensor leaves in ``jax.tree_util.tree_leaves`` order (sorted dict
    keys, lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def assert_tree_close(got, want, **tol):
    """Every leaf of the port's tree against the reference's, same
    order and shapes."""
    g, w = leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), **tol)


def assert_same_layout(got, want):
    """The port's tree has the reference's leaves, in order, at the same
    shapes (its own seeded init against the reference's)."""
    g, w = leaves(got), jax.tree_util.tree_leaves(want)
    assert [tuple(a.shape) for a in g] == [tuple(b.shape) for b in w]


def engines(model, *, max_len: int, kv_policy: str = "native", K: int = 8,
            **kw):
    """A reference and a port static engine over the same f32 weights."""
    cfg, tcfg, jp, tp = model
    ref = JaxEngine(cfg, jp, RuntimeOptions(dtype="float32", **kw),
                    max_len=max_len, kv_policy=kv_policy, decode_lookahead=K)
    port = ServeEngine(tcfg, tp, tm.RuntimeOptions(dtype="float32", **kw),
                       device="cpu", scheduler="static", max_len=max_len,
                       kv_policy=kv_policy, decode_lookahead=K)
    return ref, port


def stats(eng):
    return {c: getattr(eng.stats, c) for c in COUNTERS}
