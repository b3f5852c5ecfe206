"""The port's serving CLI and static ``generate`` against the reference's,
on the CPU.

* The two CLIs (``repro.launch.serve``, ``repro_torch.launch.serve``)
  default to the same engine: ``--scheduler static``.
* ``ServeEngine.generate(prefix_emb=...)``: a (B, P, d) stub frontend
  output prepended to the prompts' embeddings (VLM patches), on the
  reduced llama3.2-1b twin in f32 with the reference's weights. A numpy
  prefix from a seed goes through both packages' ``generate``; the tokens
  and the host syncs (and the other static counters) must be equal, and
  the prefix counts toward ``max_len``.
"""
import argparse

import jax
import numpy as np
import pytest
import torch

import repro.launch.serve as jserve
import repro_torch.launch.serve as tserve
import repro_torch.models as tm
from repro.configs import get_config
from repro.configs.reduce import reduced
from repro.models import RuntimeOptions
from repro.models import lm as jlm
from repro.serving import ServeEngine as JaxEngine
from repro_torch.configs import get_config as tget
from repro_torch.configs.reduce import reduced as treduced
from repro_torch.serving import ServeEngine

torch.set_num_threads(2)

COUNTERS = ("host_syncs", "decode_steps", "decode_compiles", "new_tokens",
            "requests")


class _Parsed(Exception):
    """Raised in place of argument parsing, once the parser is built."""


def _parser_default(main, monkeypatch, dest, *argv):
    """The default of ``dest`` in the parser ``main`` builds."""
    seen = {}

    def stop(self, args=None, namespace=None):
        seen["default"] = self.get_default(dest)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(_Parsed):
        main(*argv)
    return seen["default"]


def test_serve_clis_default_to_the_same_engine(monkeypatch):
    ref = _parser_default(jserve.main, monkeypatch, "scheduler")
    port = _parser_default(tserve.main, monkeypatch, "scheduler", [])
    assert ref == port == "static"


@pytest.fixture(scope="module")
def llama():
    cfg = reduced(get_config("llama3.2-1b"), d_model=64, n_layers=2,
                  vocab=128)
    tcfg = treduced(tget("llama3.2-1b"), d_model=64, n_layers=2, vocab=128)
    jp = jlm.init_params(cfg, jax.random.PRNGKey(0),
                         RuntimeOptions(dtype="float32"))
    tp = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return cfg, tcfg, jp, tp


@pytest.mark.parametrize("K", [1, 8])
def test_generate_prefix_emb_matches_reference(llama, K):
    cfg, tcfg, jp, tp = llama
    rng = np.random.default_rng(11)
    B, S, P, n = 3, 6, 4, 11
    prompts = rng.integers(1, cfg.vocab, size=(B, S)).astype(np.int32)
    prefix = rng.standard_normal((B, P, cfg.d_model), dtype=np.float32)
    ref = JaxEngine(cfg, jp, RuntimeOptions(dtype="float32"), max_len=40,
                    decode_lookahead=K)
    want = ref.generate(prompts, n, prefix_emb=prefix)
    eng = ServeEngine(tcfg, tp, tm.RuntimeOptions(dtype="float32"),
                      device="cpu", scheduler="static", max_len=40,
                      decode_lookahead=K)
    got = eng.generate(prompts, n, prefix_emb=prefix)
    assert got == want
    assert eng.stats.host_syncs == ref.stats.host_syncs
    assert ({c: getattr(eng.stats, c) for c in COUNTERS}
            == {c: getattr(ref.stats, c) for c in COUNTERS})
    # the prefix reaches the output: without it the wave decodes otherwise
    assert eng.generate(prompts, n) != got


def test_generate_counts_the_prefix_toward_max_len(llama):
    _, tcfg, _, tp = llama
    eng = ServeEngine(tcfg, tp, tm.RuntimeOptions(dtype="float32"),
                      device="cpu", scheduler="static", max_len=16)
    prompts = np.ones((1, 8), np.int32)
    eng.generate(prompts, 8)                       # 16 tokens fit
    with pytest.raises(ValueError, match=r"prefix\(2\).*max_len=16"):
        eng.generate(prompts, 8, prefix_emb=np.zeros((1, 2, tcfg.d_model),
                                                     np.float32))
