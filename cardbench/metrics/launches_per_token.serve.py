"""``launches_per_token.prefill`` where the cell reports its tokens per
second and not its time to first token: CUDA runtime launch calls inside
the program's prefill step functions, over the prompt tokens."""
from cardbench import spec

read = spec.reader("launches_per_token.prefill").read
