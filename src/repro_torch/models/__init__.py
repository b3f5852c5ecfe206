"""The port's decoder-only LM, dense or mixture-of-experts (PyTorch):
the model surfaces of the continuous engine (paged KV pool) and of the
static engine (dense cache)."""
from repro_torch.models.api import decode_steps, forward, module_for, prefill
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import (RuntimeOptions, copy_pages, decode_step,
                                   decode_step_paged, decode_steps_paged,
                                   decode_verify_paged, init_cache,
                                   init_paged_cache, init_params,
                                   layer_dma_slices, page_layer_nbytes,
                                   paged_supported,
                                   prefill_paged_chunk, resolve_device,
                                   spec_decode_verify, static_supported,
                                   torch_dtype)

__all__ = ["RuntimeOptions", "copy_pages", "decode_step", "decode_step_paged",
           "decode_steps", "decode_steps_paged", "decode_verify_paged",
           "forward", "init_cache", "init_paged_cache", "init_params",
           "layer_dma_slices", "module_for", "page_layer_nbytes",
           "paged_supported", "params_from_numpy", "prefill",
           "prefill_paged_chunk", "resolve_device", "spec_decode_verify",
           "static_supported", "torch_dtype"]
