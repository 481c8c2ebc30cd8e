"""Models (counterparts of openlbmpm_tpu.models)."""

from .base import RunMetrics, run_chunked
from .colorgradient import CGBoundaryConfig, ColorGradientParams, ColorGradientRK
from .flow3d import (CG3DBoundaryConfig, ColorGradientParams3D,
                     ColorGradientRK3D, TransportD3Q7, TransportRK3D)
from .shanchen import SCBoundaryConfig, ShanChenMCMP, ShanChenParams
from .transport import TransportParams, TransportRK, TransportState

__all__ = ["RunMetrics", "run_chunked", "CGBoundaryConfig",
           "ColorGradientParams", "ColorGradientRK", "CG3DBoundaryConfig",
           "ColorGradientParams3D", "ColorGradientRK3D", "SCBoundaryConfig",
           "ShanChenMCMP", "ShanChenParams", "TransportD3Q7",
           "TransportParams", "TransportRK", "TransportRK3D",
           "TransportState"]
