"""Plain references: PyTorch operations in float32 with TF32 off, no
kernel, cache or batching of the program.  They import nothing of the
program (``repro_torch``) and nothing of jax or the JAX package."""
