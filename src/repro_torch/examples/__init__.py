"""The JAX package's examples on the port: each runs with
``python -m repro_torch.examples.<name>``, makes its traces on the GPU
unless ``--device cpu`` is given, and prints what the reference example
prints."""
