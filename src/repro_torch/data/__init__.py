from repro_torch.data.pipeline import SyntheticLM, batch_for_step

__all__ = ["SyntheticLM", "batch_for_step"]
