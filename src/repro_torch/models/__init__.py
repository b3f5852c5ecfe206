"""The port's model zoo (PyTorch): the decoder-only LM (dense, MoE, MLA,
VLM; the continuous engine's paged surfaces and the static engine's dense
cache), the Mamba-2 LM, the Zamba2 hybrid and the Whisper
encoder-decoder (static engine), behind the family dispatch of
``models.api``, and each family's training loss (``train_loss``)."""
from repro_torch.models.api import (SHAPES, ShapeSpec, cell_runnable,
                                    decode_step, decode_steps, forward,
                                    init_cache, init_params,
                                    input_specs, kernel_width_reason,
                                    module_for,
                                    paged_supported, prefill,
                                    static_supported, train_loss)
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import (RuntimeOptions, copy_pages,
                                   decode_step_paged, decode_steps_paged,
                                   decode_verify_paged, init_paged_cache,
                                   layer_dma_slices, page_layer_nbytes,
                                   prefill_paged_chunk, reset_cache,
                                   reset_paged_cache,
                                   resolve_device, spec_decode_verify,
                                   torch_dtype)

__all__ = ["RuntimeOptions", "SHAPES", "ShapeSpec", "cell_runnable",
           "input_specs", "copy_pages", "decode_step", "decode_step_paged",
           "decode_steps", "decode_steps_paged", "decode_verify_paged",
           "forward", "init_cache", "init_paged_cache", "init_params",
           "kernel_width_reason", "layer_dma_slices", "module_for", "page_layer_nbytes",
           "paged_supported", "params_from_numpy", "prefill",
           "prefill_paged_chunk", "reset_cache", "reset_paged_cache", "resolve_device",
           "spec_decode_verify",
           "static_supported", "torch_dtype", "train_loss"]
