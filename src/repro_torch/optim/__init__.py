"""Optimizers and gradient compression of the port (``repro.optim``)."""

from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adamw,
    adafactor,
    cosine_schedule,
    clip_by_global_norm,
    make_optimizer,
)
from repro_torch.optim.compression import int8_error_feedback, int8_error_feedback_  # noqa: F401
