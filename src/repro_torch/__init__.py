"""PyTorch/CUDA port of the ``repro`` serving stack for the NVIDIA H100.

Mirrors the reference package's layout module for module; imports nothing
of it and nothing of JAX. Entry points run on the card (``device="cuda"``)
unless the caller asks for the CPU."""
