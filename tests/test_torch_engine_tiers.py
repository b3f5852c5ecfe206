"""The port's engine under a tiered KV hierarchy (a small fast tier that
spills to simulated HBS, as ``--kv-fast-mb`` builds it), held token for
token against the reference engine, and the port's serve CLI on the CPU."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.reduce import reduced
from repro.core import hbs as jhbs
from repro.core import lpddr6 as jlpddr6
from repro.core import npu_hierarchy as jnpu_hierarchy
from repro.models import RuntimeOptions
from repro.models import lm as jlm
from repro.serving import ServeEngine as JaxEngine
import repro_torch.models as tm
from repro_torch.configs import get_config as tget
from repro_torch.configs.reduce import reduced as treduced
from repro_torch.core import hbs, lpddr6, npu_hierarchy
from repro_torch.launch import serve as tserve
from repro_torch.serving import ServeEngine
from repro_torch.serving.kv_manager import page_bytes

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models():
    cfg = reduced(get_config("llama3.2-1b"), d_model=64, n_layers=2,
                  vocab=128)
    tcfg = treduced(tget("llama3.2-1b"), d_model=64, n_layers=2, vocab=128)
    jp = jlm.init_params(cfg, jax.random.PRNGKey(0),
                         RuntimeOptions(dtype="float32"))
    tp = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return cfg, tcfg, jp, tp


def _hierarchies(tcfg, fast_pages, dtype_bytes, page_size=8):
    """The same fast/HBS hierarchy built by each package's own memspec,
    with a fast tier of ``fast_pages`` pages at the pool's width."""
    pb = page_bytes(tcfg, page_size, dtype_bytes)
    fast_gb = fast_pages * pb / 1e9
    return (jnpu_hierarchy(jlpddr6(capacity_gb=fast_gb),
                           jhbs(8.0, latency_us=20.0, capacity_gb=1.0)),
            npu_hierarchy(lpddr6(capacity_gb=fast_gb),
                          hbs(8.0, latency_us=20.0, capacity_gb=1.0)))


@pytest.mark.parametrize("kv_policy", ["native", "int8"])
def test_spilled_run_token_identical_to_reference(models, kv_policy):
    """Three concurrent requests whose joint KV overflows a 4-page fast
    tier: pages spill and stream back, the tokens do not change."""
    cfg, tcfg, jp, tp = models
    rng = np.random.default_rng(3)
    reqs = [rng.integers(1, cfg.vocab, size=n).tolist() for n in (20, 9, 14)]
    kw = dict(max_len=40, scheduler="continuous", page_size=8, max_batch=3,
              prefill_budget=96, kv_policy=kv_policy, overlap=False,
              hbs_gbps=1e-3, hbs_latency_us=500.0)
    jh, th = _hierarchies(tcfg, 4, 1 if kv_policy == "int8" else 4)
    ref = JaxEngine(cfg, jp, RuntimeOptions(dtype="float32"), hierarchy=jh,
                    **kw)
    want = ref.serve([r[:] for r in reqs], 8)
    eng = ServeEngine(tcfg, tp, tm.RuntimeOptions(dtype="float32"),
                      device="cpu", hierarchy=th, **kw)
    got = eng.serve([r[:] for r in reqs], 8)
    assert got == want
    s, r = eng.stats, ref.stats
    assert s.pages_fetched > 0 and s.stall_s > 0.0     # it really streamed
    assert s.peak_fast_pages <= 4                      # the budget held
    assert (s.host_syncs, s.pages_spilled, s.pages_fetched) == (
        r.host_syncs, r.pages_spilled, r.pages_fetched)
    assert eng.trace_report["ok"] and eng.kv_manager.n_used == 0


def test_serve_cli_runs_on_cpu(capsys, tmp_path):
    trace = tmp_path / "trace.json"
    tserve.main(["--arch", "llama3.2-1b", "--reduced", "--d-model", "64",
                 "--device", "cpu", "--scheduler", "continuous",
                 "--concurrency", "3", "--prompt-len",
                 "12", "--new-tokens", "5", "--shared-doc", "8",
                 "--page-size", "4", "--prefill-chunk", "8",
                 "--kv-policy", "int8", "--trace-out", str(trace),
                 "--slo-ttft-ms", "1e6"])
    out = capsys.readouterr().out
    assert "[serve] arch=llama3.2-1b device=cpu" in out
    assert "cached=" in out and "goodput: 3/3" in out
    assert "reconciled=True" in out and trace.exists()


def test_serve_cli_offload_flags(capsys):
    tserve.main(["--arch", "llama3.2-1b", "--reduced", "--d-model", "64",
                 "--device", "cpu", "--scheduler", "continuous",
                 "--concurrency", "3", "--prompt-len",
                 "16", "--new-tokens", "4", "--page-size", "4",
                 "--prefill-chunk", "8", "--kv-fast-mb", "0.004",
                 "--hbs-gbps", "0.01"])
    assert "[serve] offload: stall=" in capsys.readouterr().out


@pytest.mark.parametrize("flags,reason", [
    (["--scheduler", "continuous", "--arch", "gemma3-1b"],
     "sliding-window layers"),
    (["--scheduler", "continuous", "--arch", "paligemma-3b"],
     "family 'vlm' is not covered by the paged KV path"),
    # the reference's paged_supported reasons; both run on the static engine
    (["--scheduler", "continuous", "--arch", "deepseek-v2-236b"],
     "MLA latent cache is already compressed"),
    (["--scheduler", "continuous", "--arch", "mamba2-130m"],
     "family 'ssm' has no paged serving path"),
    # head sharding needs a shard count that divides the KV heads (4 in
    # the reduced config): the engine raises in the spawned ranks, and the
    # CLI re-raises it
    (["--scheduler", "continuous", "--shards", "3"], "n_kv_heads")])
def test_serve_cli_rejects_off_path_flags(flags, reason):
    exc = ValueError if "--shards" in flags else NotImplementedError
    with pytest.raises(exc, match=reason):
        tserve.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
                     *flags])


def test_serve_cli_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--arch", "llama3.2-1b", "--reduced"])
