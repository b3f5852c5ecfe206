"""Memory-hierarchy specification (``memspec``), as the serve CLI's
``--kv-fast-mb``/``--chiplet-mb`` tiers need it."""
from repro_torch.core import memspec
from repro_torch.core.memspec import (ComputeSpec, MemoryHierarchy,
                                      MemoryLevel, hbs, lpddr6, npu_hierarchy,
                                      sram_chiplet, ssd_pcie)

__all__ = ["memspec", "ComputeSpec", "MemoryHierarchy", "MemoryLevel", "hbs",
           "lpddr6", "npu_hierarchy", "sram_chiplet", "ssd_pcie"]
