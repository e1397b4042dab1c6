"""``prefill_ms`` where the cell reports its tokens per second and not
its time to first token: the mean host time of a round's prefill."""
from cardbench import spec

read = spec.reader("prefill_ms").read
