"""The roofline of the dry run (counterpart of ``repro/roofline``):
:mod:`.analysis` (the H100's constants, the terms, the analytic counts
and the step counter) and :mod:`.report` (the table over the dry run's
records)."""
from .analysis import (HW, StepCounter, collective_bytes_from_stats,
                       model_flops, roofline_terms)

__all__ = ["HW", "StepCounter", "collective_bytes_from_stats", "model_flops",
           "roofline_terms"]
