"""PyTorch + CUDA port of the VolTune reproduction, for NVIDIA Hopper.

Mirrors `src/repro/` module for module; the JAX package stays the
reference it is tested against. Imports torch, never jax, and nothing of
`repro`. Entry points take `device=` (default "cuda") and raise when no
card is present unless the caller asks for the CPU."""
