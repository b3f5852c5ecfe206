"""The port's paged decoder-only LM (PyTorch): the continuous engine's
model surface."""
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import (RuntimeOptions, copy_pages,
                                   decode_step_paged, decode_steps_paged,
                                   decode_verify_paged, init_paged_cache,
                                   init_params, layer_dma_slices,
                                   page_layer_nbytes, paged_supported,
                                   prefill_paged_chunk, resolve_device,
                                   spec_decode_verify, torch_dtype)

__all__ = ["RuntimeOptions", "copy_pages", "decode_step_paged",
           "decode_steps_paged", "decode_verify_paged", "init_paged_cache",
           "init_params", "layer_dma_slices", "page_layer_nbytes",
           "paged_supported", "params_from_numpy", "prefill_paged_chunk",
           "resolve_device", "spec_decode_verify", "torch_dtype"]
