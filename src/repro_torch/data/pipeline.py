"""Deterministic synthetic token pipeline, in PyTorch (the reference is
``repro/data/pipeline.py``).

``batch_at(step)`` is a pure function of (seed, step), drawn from a CPU
``torch.Generator`` seeded from both, so a restarted job resumes on the
same token stream with no loader state in its checkpoints. The marginals
are the reference's: squared-uniform ids in [1, V) (low ids more likely)
and, with probability 0.5, the previous draw + 1 (mod V) instead, so the
loss of a model that learns the pattern falls. The reference draws with
JAX's threefry, which PyTorch does not reproduce: the two streams differ
(tests that compare the packages feed the port the reference's batches).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


def step_generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator seeded from (seed, step). The CPU generator (a
    Mersenne twister) keeps 32 bits of its seed, so the pair is hashed
    into them by numpy's ``SeedSequence``."""
    key = np.random.SeedSequence([int(seed), int(step)]).generate_state(1)
    return torch.Generator().manual_seed(int(key[0]))


def draws(g: torch.Generator, B: int, S: int, V: int):
    """(base ids (B, S) in [1, V - 1), repeat flags (B, S)) from ``g``:
    base = int(u * u * (V - 2)) + 1 with u uniform, each flag true with
    probability 0.5."""
    u = torch.rand((B, S), generator=g)
    base = (u * u * (V - 2)).to(torch.int32) + 1
    rep = torch.rand((B, S), generator=g) < 0.5
    return base, rep


@dataclass
class SyntheticTextDataset:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    prefix_len: int = 0     # VLM patch / audio-frame stub embeddings
    d_model: int = 0

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """{"tokens", "labels"} (B, S) int32 on the CPU (the same tensor:
        next-token labels are shifted by the loss), and "prefix_emb" (B,
        prefix_len, d_model) f32 of N(0, 0.02^2) for a VLM or an
        encoder-decoder."""
        g = step_generator(self.seed, step)
        B, S, V = self.global_batch, self.seq_len, self.vocab
        base, rep = draws(g, B, S, V)
        shifted = torch.roll(base, 1, dims=1) + 1
        tokens = torch.where(rep, shifted % V, base)
        batch = {"tokens": tokens, "labels": tokens}
        if self.prefix_len and self.d_model:
            batch["prefix_emb"] = torch.randn(
                (B, self.prefix_len, self.d_model), generator=g) * 0.02
        return batch


def for_arch(cfg: ArchConfig, seq_len: int, global_batch: int,
             seed: int = 0) -> SyntheticTextDataset:
    """The dataset of ``cfg``: its vocabulary, and a prefix of
    ``prefix_len`` patches (VLM) or ``source_len`` frames (encoder-decoder)
    at ``d_model``."""
    prefix = cfg.prefix_len or (cfg.source_len if cfg.family == "encdec"
                                else 0)
    return SyntheticTextDataset(vocab=cfg.vocab, seq_len=seq_len,
                                global_batch=global_batch, seed=seed,
                                prefix_len=prefix, d_model=cfg.d_model)
