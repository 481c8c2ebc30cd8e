"""Models (counterparts of openlbmpm_tpu.models)."""

from .base import RunMetrics, run_chunked
from .colorgradient import CGBoundaryConfig, ColorGradientParams, ColorGradientRK

__all__ = ["RunMetrics", "run_chunked", "CGBoundaryConfig",
           "ColorGradientParams", "ColorGradientRK"]
