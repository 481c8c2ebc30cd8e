"""Models (counterparts of openlbmpm_tpu.models)."""

from .base import RunMetrics, run_chunked
from .colorgradient import CGBoundaryConfig, ColorGradientParams, ColorGradientRK
from .flow3d import (CG3DBoundaryConfig, ColorGradientParams3D,
                     ColorGradientRK3D, ShanChenMCMP3D, ShanChenParams3D,
                     SinglePhaseD3Q19, TransportD3Q7, TransportRK3D)
from .shanchen import SCBoundaryConfig, ShanChenMCMP, ShanChenParams
from .single_phase import BoundaryConfig, SinglePhaseD2Q9
from .transport import TransportParams, TransportRK, TransportState

__all__ = ["RunMetrics", "run_chunked", "BoundaryConfig", "CGBoundaryConfig",
           "ColorGradientParams", "ColorGradientRK", "CG3DBoundaryConfig",
           "ColorGradientParams3D", "ColorGradientRK3D", "SCBoundaryConfig",
           "ShanChenMCMP", "ShanChenMCMP3D", "ShanChenParams",
           "ShanChenParams3D", "SinglePhaseD2Q9", "SinglePhaseD3Q19",
           "TransportD3Q7", "TransportParams", "TransportRK", "TransportRK3D",
           "TransportState"]
