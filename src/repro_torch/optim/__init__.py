from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.schedule import (cosine_schedule, wsd_schedule,
                                        make_schedule)
from repro_torch.optim.compress import (compress_int8, decompress_int8,
                                        error_feedback_update)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "wsd_schedule", "make_schedule", "compress_int8",
           "decompress_int8", "error_feedback_update"]
