"""Sharding rules of the port (the reference is ``repro/sharding``): which
mesh axes each parameter, optimizer state, input and cache dimension is
split over, and the DTensor placements that carry them out."""
from repro_torch.sharding.rules import (P, NamedSharding, batch_axes,
                                        cache_pspecs, data_pspecs,
                                        effective_batch_axes,
                                        opt_state_pspec, paged_cache_pspecs,
                                        param_pspecs, placements)

__all__ = ["NamedSharding", "P", "batch_axes", "cache_pspecs", "data_pspecs",
           "effective_batch_axes", "opt_state_pspec", "paged_cache_pspecs",
           "param_pspecs", "placements"]
