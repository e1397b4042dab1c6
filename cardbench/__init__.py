"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once.  Everything that
belongs to one configuration, traffic mix, cell or per-layer metric is a
file of its own, found by its name: ``configs/<config>.json``,
``traffic/<mix>.json``, ``limits/<cell>.json`` and
``metrics/<metric>.py``.  The plain fp32 reference of each configuration
is ``reference/<name>.py``, the name given by the configuration's
``reference`` key, and its parameter tree and model-flop count are
``layouts/<name>.py``, the name given by its ``layout`` key (``lm``
without one).  Nothing here imports jax, jaxlib or the JAX package.
"""
