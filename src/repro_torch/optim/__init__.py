"""The optimizer (counterpart of ``repro/optim``): AdamW with global-norm
clipping, the cosine schedule, and int8 gradient compression with error
feedback, on dicts of tensors (a parameter name -> tensor, as
``LM.named_parameters`` gives them) in place of pytrees."""
from .adamw import AdamW, AdamWState, adamw, clip_by_global_norm
from .compress import compress_gradients, error_feedback_init
from .schedule import cosine_schedule

__all__ = ["AdamW", "AdamWState", "adamw", "clip_by_global_norm",
           "cosine_schedule", "compress_gradients", "error_feedback_init"]
