"""Shared set-up of the port's training tests: a family's reduced twin in
both packages with the reference's f32 weights, the reference's batch (as
numpy, then tensors), and the reference's loss and gradients by
``jax.value_and_grad`` of ``repro.models.train_loss``."""
import functools

import jax
import numpy as np
import torch

import repro_torch.models as tm
from repro.configs import get_config
from repro.configs.reduce import reduced
from repro.data.pipeline import for_arch
from repro.models import RuntimeOptions
from repro.models import api as japi
from repro.models import train_loss as jtrain_loss
from repro_torch.configs import get_config as tget
from repro_torch.configs.reduce import reduced as treduced
from repro_torch.tree import leaves, tree_map

# f32 tolerances against the reference: the loss's relative error, and a
# gradient leaf's max |error| <= GRAD_RTOL * max |g_ref| + GRAD_ATOL
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6

F32 = RuntimeOptions(dtype="float32")
TF32 = tm.RuntimeOptions(dtype="float32")


def batch_tensors(jbatch):
    """The reference's batch as CPU tensors."""
    return {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}


def twin(arch: str, seed: int = 0, **reduce_kw):
    """(cfg, tcfg, reference params, port params): ``arch`` reduced to
    d_model 64 and vocab 128 in both packages, the reference's seeded f32
    weights (drawn under ``jax.jit``) converted for the port."""
    kw = dict(d_model=64, vocab=128, **reduce_kw)
    cfg = reduced(get_config(arch), **kw)
    tcfg = treduced(tget(arch), **kw)
    jp = jax.jit(lambda k: japi.init_params(cfg, k, F32))(
        jax.random.PRNGKey(seed))
    tp = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return cfg, tcfg, jp, tp


@functools.lru_cache(maxsize=None)
def reference(arch: str, B: int = 2, S: int = 16, **reduce_kw):
    """(model, reference batch, loss, aux, gradient leaves) of ``arch``'s
    twin (``twin``): the loss and gradients of the reference's batch at
    step 0 of seed 1 by ``jax.value_and_grad`` (under ``jax.jit``)."""
    model = twin(arch, **reduce_kw)
    cfg, _, jp, _ = model
    jb = for_arch(cfg, S, B, seed=1).batch_at(0)
    (loss, aux), g = jax.jit(jax.value_and_grad(
        lambda p, b: jtrain_loss(cfg, p, b, F32), has_aux=True))(jp, jb)
    return (model, jax.tree_util.tree_map(np.asarray, jb), float(loss),
            {k: float(v) for k, v in aux.items()},
            [np.asarray(x) for x in jax.tree_util.tree_leaves(g)])


def port_grads(tcfg, tp, batch, opts=TF32):
    """(loss, aux, gradient leaves in pytree order) of the port's
    ``train_loss`` by autograd."""
    p = tree_map(lambda t: t.detach().requires_grad_(), tp)
    loss, aux = tm.train_loss(tcfg, p, batch, opts)
    return loss.detach(), aux, torch.autograd.grad(loss, leaves(p))


def assert_grads_close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b, np.float32)
        assert tuple(a.shape) == b.shape
        err = float(np.abs(a.detach().float().cpu().numpy() - b).max())
        assert err <= GRAD_RTOL * float(np.abs(b).max()) + GRAD_ATOL, err
