"""The trainer's optimizer (AdamW on dicts of tensors) and int8 gradient
compression: the counterpart of ``repro.optim``."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_update, global_norm,
                                     init_opt_state, schedule)

__all__ = ["AdamWConfig", "adamw_update", "global_norm", "init_opt_state",
           "schedule"]
