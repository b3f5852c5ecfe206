"""Weight bridge from the reference package: its ``init_params`` pytree,
as numpy arrays, becomes the port's params dict, layout unchanged (dense
weights stay ``(d_in, d_out)``; ``params["stack"]`` keeps its leading
``n_layers`` axis). The caller turns the JAX arrays into numpy
(``jax.tree_util.tree_map(np.asarray, params)``), so this module needs no
JAX."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.lm import resolve_device, torch_dtype


def params_from_numpy(tree, *, device="cuda", dtype=None):
    """Nested dicts/lists of numpy arrays -> the same nesting of tensors on
    ``device``. Floating arrays are cast to ``dtype`` when given (else they
    keep their own float type); integer arrays keep theirs."""
    device = resolve_device(device)
    dtype = None if dtype is None else torch_dtype(dtype)

    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(one(v) for v in x)
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":      # ml_dtypes: numpy has no bf16
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, copy=True, order="C"))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)
    return one(tree)
