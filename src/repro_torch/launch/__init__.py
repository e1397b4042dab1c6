"""Launch layer: step builders and the batched serving driver."""
