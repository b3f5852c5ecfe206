"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version."""
import importlib

# every kernel entry that counts its launches (``.launches`` and
# ``.launches_by_heads``), by name, and the module of this package that
# holds it
ENTRIES = {"paged_decode_attention": "decode_attention",
           "chunk_prefill_attention": "decode_attention",
           "spec_verify_attention": "decode_attention",
           "decode_attention": "decode_attention",
           "flash_attention": "flash_attention"}


def entries() -> dict:
    """name -> the entry of ``ENTRIES`` (its module imported on the first
    call, not with this package)."""
    return {name: getattr(importlib.import_module(f"{__name__}.{mod}"), name)
            for name, mod in ENTRIES.items()}
