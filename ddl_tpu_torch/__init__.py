"""ddl_tpu_torch: the PyTorch and CUDA port of ddl_tpu for one NVIDIA H100.

The JAX package ``ddl_tpu`` stays the reference; this package imports
nothing of it (nor JAX) and keeps its own copies of what it needs.  Entry
points run on the card (``device=None`` means ``"cuda"``) unless the caller
asks for the CPU.
"""
