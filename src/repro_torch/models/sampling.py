"""On-device token choice. Only greedy sampling is ported; stochastic
sampling and speculative acceptance are ROADMAP item A5."""
from __future__ import annotations

import torch


def sample_greedy(logits):
    """Greedy argmax over the last axis, int32. ``torch.argmax`` returns
    the first maximum, as ``np.argmax`` and ``jnp.argmax`` do — the
    fused-decode identity invariant."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
