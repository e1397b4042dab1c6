"""Conduit reproduction on PyTorch and CUDA: the same pipeline as the JAX
package ``repro``, module for module, with its TPU kernels rewritten by hand
for NVIDIA Hopper.

Public API (the slices ported so far):
    repro_torch.core.vectorize   compile-time pass: torch fn -> vector IR
    repro_torch.sim.simulate     event-driven execution under any policy
    repro_torch.workloads        get_trace / run_numeric / make_inputs
    repro_torch.kernels.ops      the NDP-resource kernels (CUDA on the card,
                                 their plain PyTorch versions on the CPU)
"""
__version__ = "0.1.0"
