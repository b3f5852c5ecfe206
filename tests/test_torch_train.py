"""The port's training substrate on the CPU: the synthetic pipeline
(``repro_torch.data``), the fault-tolerant loop (``repro_torch.train``:
loss decreases, resumes from its newest checkpoint, a SIGTERM checkpoints
and exits at the next step boundary, metrics.jsonl) and the train CLI."""
import json
import os
import pathlib
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.reduce import reduced
from repro_torch.data import SyntheticTextDataset, for_arch
from repro_torch.data.pipeline import draws, step_generator
from repro_torch.models import RuntimeOptions
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, train

torch.set_num_threads(2)

OPTS = RuntimeOptions(dtype="float32")
ROOT = pathlib.Path(__file__).resolve().parents[1]


# ------------------------------ data ----------------------------------- #

def test_batch_is_a_pure_function_of_seed_and_step():
    ds = SyntheticTextDataset(vocab=64, seq_len=16, global_batch=4, seed=3)
    a, b, c = ds.batch_at(7), ds.batch_at(7), ds.batch_at(8)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    other = SyntheticTextDataset(vocab=64, seq_len=16, global_batch=4,
                                 seed=4).batch_at(7)
    assert not torch.equal(a["tokens"], other["tokens"])
    assert a["tokens"].dtype == torch.int32
    assert torch.equal(a["tokens"], a["labels"])


@pytest.mark.parametrize("vocab", [64, 32000])
def test_ids_and_repeat_share(vocab):
    """Ids lie in [1, V); about half of them (0.4-0.6 over 8,192) are the
    previous draw + 1 (mod V), as the reference's Markov structure."""
    B, S = 8, 1024
    ds = SyntheticTextDataset(vocab=vocab, seq_len=S, global_batch=B,
                              seed=1)
    tok = ds.batch_at(5)["tokens"]
    assert int(tok.min()) >= 1 and int(tok.max()) < vocab
    base, rep = draws(step_generator(1, 5), B, S, vocab)
    assert 0.4 <= float(rep.float().mean()) <= 0.6
    prev = torch.roll(base, 1, dims=1) + 1
    assert torch.equal(tok, torch.where(rep, prev % vocab, base))
    # squared uniform: the lower half of the ids holds ~71% of the draws
    assert 0.65 <= float((base < vocab // 2).float().mean()) <= 0.77


def test_prefix_embeddings_for_vlm_and_encdec():
    for arch, n in (("llava15-13b", "prefix_len"),
                    ("whisper-medium", "source_len")):
        cfg = reduced(get_config(arch))
        b = for_arch(cfg, 16, 4, seed=0).batch_at(0)
        assert b["prefix_emb"].shape == (4, getattr(cfg, n), cfg.d_model)
        assert b["prefix_emb"].dtype == torch.float32
        assert 0.015 <= float(b["prefix_emb"].std()) <= 0.025
    b = for_arch(reduced(get_config("yi-6b")), 16, 4).batch_at(0)
    assert "prefix_emb" not in b


# ---------------------------- train loop ------------------------------- #

def _tiny_cfg():
    return reduced(get_config("yi-6b"), d_model=32, n_layers=2, vocab=64)


def _tcfg(tmp_path, **kw):
    base = dict(steps=12, seq_len=32, global_batch=4, ckpt_every=6,
                ckpt_dir=str(tmp_path), log_every=100,
                optimizer=AdamWConfig(lr=3e-3, warmup_steps=2,
                                      total_steps=12))
    return TrainConfig(**{**base, **kw})


def test_loss_decreases_and_resumes(tmp_path):
    tcfg = _tcfg(tmp_path)
    out = train(_tiny_cfg(), tcfg, OPTS, log_fn=None, device="cpu")
    assert out["last_step"] == 12 and not out["preempted"]
    assert out["losses"][-1] < out["losses"][0]
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_12",
                                                             "step_6"]
    # resume: continue to 16 steps from the step-12 checkpoint
    logs = []
    out2 = train(_tiny_cfg(), _tcfg(tmp_path, steps=16), OPTS,
                 log_fn=logs.append, device="cpu")
    assert logs[0] == "[train] resumed from step 12"
    assert out2["last_step"] == 16
    assert len(out2["losses"]) == 4      # only steps 12..15 re-run
    lines = (tmp_path / "metrics.jsonl").read_text().strip().splitlines()
    assert len(lines) == 16
    rows = [json.loads(line) for line in lines]
    assert [r["step"] for r in rows] == list(range(16))
    assert all(set(r) == {"step", "loss", "dt_ms", "straggler"}
               for r in rows)
    assert [r["loss"] for r in rows[:12]] == out["losses"]


def test_resume_continues_the_same_steps(tmp_path):
    """Steps 6..11 resumed from the step-6 checkpoint give the losses of
    the straight run: same state, same batches."""
    straight = train(_tiny_cfg(), _tcfg(tmp_path / "a"), OPTS, log_fn=None,
                     device="cpu")["losses"]
    train(_tiny_cfg(), _tcfg(tmp_path / "b", steps=6), OPTS, log_fn=None,
          device="cpu")
    resumed = train(_tiny_cfg(), _tcfg(tmp_path / "b"), OPTS, log_fn=None,
                    device="cpu")["losses"]
    np.testing.assert_allclose(resumed, straight[6:], rtol=1e-5)


def test_sigterm_checkpoints_at_the_next_boundary(tmp_path):
    """A SIGTERM during step k: the loop finishes it, checkpoints k + 1 and
    exits with ``preempted``; the handlers are restored afterwards."""
    k = 2
    before = signal.getsignal(signal.SIGTERM)

    def log_fn(msg):
        if msg.startswith(f"[train] step={k} "):
            os.kill(os.getpid(), signal.SIGTERM)
    out = train(_tiny_cfg(), _tcfg(tmp_path, log_every=1), OPTS,
                log_fn=log_fn, device="cpu")
    assert out["preempted"] and out["last_step"] == k + 1
    assert len(out["losses"]) == k + 1
    assert (tmp_path / f"step_{k + 1}" / "manifest.json").exists()
    assert signal.getsignal(signal.SIGTERM) == before


def test_train_rejects_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(_tiny_cfg(), TrainConfig(steps=1), OPTS, log_fn=None)


def test_train_cli_runs(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "yi-6b",
         "--reduced", "--device", "cpu", "--steps", "4", "--seq-len", "16",
         "--batch", "2", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "[train] done: steps=4" in r.stdout
    assert (tmp_path / "step_4" / "manifest.json").exists()
