"""Weight bridge from the reference package: its ``init_params`` pytree,
as numpy arrays, becomes the port's params dict, layout unchanged (dense
weights stay ``(d_in, d_out)``; stacks keep their leading layer axes
(Zamba's backbone its (sites, per-site) pair); lists, such as the
unstacked ``head_layers``, stay lists; an MoE stack's ``moe`` subtree
comes across as it is). The caller turns the JAX arrays into numpy
(``jax.tree_util.tree_map(np.asarray, params)``), so this module needs no
JAX."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.lm import resolve_device, torch_dtype


# subtrees the reference initializes in f32 whatever the params' dtype
_F32 = ("router", "A_log", "D", "dt_bias")


def params_from_numpy(tree, *, device="cuda", dtype=None):
    """Nested dicts/lists of numpy arrays -> the same nesting of tensors on
    ``device``. Floating arrays are cast to ``dtype`` when given (else they
    keep their own float type), except those the reference keeps in f32
    at any dtype: an MoE router's and a Mamba block's ``A_log``, ``D`` and
    ``dt_bias``; integer arrays keep theirs."""
    device = resolve_device(device)
    dtype = None if dtype is None else torch_dtype(dtype)

    def one(x, cast=True):
        if isinstance(x, dict):
            return {k: one(v, cast and k not in _F32) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(one(v, cast) for v in x)
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":      # ml_dtypes: numpy has no bf16
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, copy=True, order="C"))
        if cast and dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)
    return one(tree)
