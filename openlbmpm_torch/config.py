"""The legacy INI dialect read into the port's parameter dataclasses
(counterpart of ``openlbmpm_tpu/config.py`` for every family: the
colour-gradient (2-D and 3-D), transport, Shan-Chen (2-D and 3-D) and
single-phase (2-D and 3-D) ones).

The JAX module imports the JAX models, so its reader is copied here rather
than imported.  The dataclasses returned are the port's own
(``ColorGradientParams``, ``CGBoundaryConfig``, ``TransportParams``,
``ShanChenParams``, ``SCBoundaryConfig``, ``ColorGradientParams3D``,
``CG3DBoundaryConfig``, ``ShanChenParams3D``); their fields equal the JAX
ones field by field for the same file (``tests/test_torch_cli.py``,
``tests/test_torch_shanchen.py``, ``tests/test_torch_cg3d.py``,
``tests/test_torch_single.py``, ``tests/test_torch_flow3d.py``).  One
difference: an unknown Shan-Chen ``ForcingMethod`` raises ValueError, where
the JAX reader falls back to ``shift`` without a word.
"""

from __future__ import annotations

import configparser
import dataclasses
import os

import numpy as np

from .models.colorgradient import CGBoundaryConfig, ColorGradientParams
from .models.flow3d import (CG3DBoundaryConfig, ColorGradientParams3D,
                            ShanChenParams3D)
from .models.shanchen import SCBoundaryConfig, ShanChenParams
from .models.transport import TransportParams

__all__ = ["LegacyIni", "DomainSpec", "RunSpec", "load_colorgradient",
           "load_colorgradient3d", "load_transport", "load_shanchen",
           "load_shanchen3d", "load_basic3d", "load_basic"]


class LegacyIni:
    """configparser wrapper understanding the reference's quoted dialect."""

    def __init__(self, path: str):
        self.path = path
        cp = configparser.ConfigParser(inline_comment_prefixes=(";",))
        with open(path) as fh:
            cp.read_string(fh.read())
        self.cp = cp

    def raw(self, section: str, *keys: str, default=None):
        """First matching key among `keys` (handles key drift)."""
        if self.cp.has_section(section):
            for k in keys:
                if self.cp.has_option(section, k):
                    return self.cp.get(section, k)
        if default is not None:
            return default
        raise KeyError(f"{self.path}: [{section}] {'/'.join(keys)}")

    def text(self, section, *keys, default=None) -> str:
        v = self.raw(section, *keys, default=default)
        return str(v).strip().strip("'\"")

    def yesno(self, section, *keys, default="no") -> bool:
        return self.text(section, *keys, default=default).lower() == "yes"

    def number(self, section, *keys, default=None) -> float:
        return float(self.text(section, *keys, default=default))

    def integer(self, section, *keys, default=None) -> int:
        return int(float(self.text(section, *keys, default=default)))

    def floats(self, section, *keys, default=None) -> tuple:
        txt = self.text(section, *keys, default=default)
        return tuple(float(t) for t in txt.split(",") if t.strip())


@dataclasses.dataclass(frozen=True)
class DomainSpec:
    nx: int
    ny: int
    buffer_layers: int = 0
    use_image: bool = False
    image_path: str = ""
    duplicate: tuple[int, int] = (1, 1)


@dataclasses.dataclass(frozen=True)
class RunSpec:
    num_steps: int
    io_interval: int = 1000
    is_cycle: bool = False
    last_step: int = 0
    output_dir: str = "results"


def _bc_name(txt: str) -> str:
    return {"neumann": "neumann", "dirichlet": "dirichlet", "dirilcht":
            "dirichlet", "convective": "convective", "periodic": "periodic",
            "averageconvective": "convective_average"}.get(
        txt.lower(), "periodic")


def load_colorgradient(path: str):
    """Parse an ``RKtwophasesetup2D.ini``-style file
    (key map: ``RKD2Q9.py:24-297``)."""
    ini = LegacyIni(path)
    variant = ini.text("SurfaceTension", "SurfaceTensionType", default="CSF")
    params = ColorGradientParams(
        tau_r=ini.number("FluidParameters", "TauR", default=1.0),
        tau_b=ini.number("FluidParameters", "TauB", default=1.0),
        surface_tension=ini.number(
            "SurfaceTension", "SurfaceTension", "SurfaceTensionValue",
            default=0.1),
        contact_angle_deg=ini.number("SurfaceTension", "ContactAngle",
                                     default=60.0),
        beta=ini.number("RKParameters", "BetaThickness", default=0.7),
        delta=ini.number("RKParameters", "DeltaValue", default=0.98),
        tau_type=ini.integer("FluidParameters", "TauType", default=1),
        wetting_type=ini.integer("SurfaceTension", "WettingType", default=2),
        variant="CSF" if variant.upper() == "CSF" else "Perturbation",
        collision="MRT" if ini.text("RelaxationType", "Type",
                                    default="SRT").upper() == "MRT" else "SRT",
        solid_phi=ini.number("SolidBoundarySetup", "SolidColorDiff",
                             default=0.5),
        alpha_r=ini.number("RKParameters", "AlphaR", default=4.0 / 9.0),
        alpha_b=ini.number("RKParameters", "AlphaB", default=4.0 / 9.0),
        a_kr=ini.number("RKParameters", "AkR", default=1e-4),
        a_kb=ini.number("RKParameters", "AkB", default=1e-4),
        body_force=(ini.number("BodyForce", "bodyForceX", default=0.0),
                    ini.number("BodyForce", "bodyForceY", default=0.0)),
        gradient_type=ini.text("GradientType", "Type", default="Isotropic"),
    )
    inlet = _bc_name(ini.text("BoundaryCondition", "BoundaryTypeInlet",
                              default="periodic"))
    # VelocityType = 'PerColor' selects the per-color Zou-He velocity inlet
    # (``RKGPU2DBoundary.constantVelocityZHBoundaryHigherRK:11-56``; the
    # reference comments it against the total-momentum inlet at
    # ``RKD2Q9.py:1306-1311``)
    if inlet == "neumann" and ini.text(
            "BoundaryCondition", "VelocityType",
            default="Total").lower() == "percolor":
        inlet = "neumann_per_color"
    outlet = _bc_name(ini.text("BoundaryCondition", "BoundaryTypeOutlet",
                               default="periodic"))
    bcs = CGBoundaryConfig(
        inlet=inlet,
        outlet=outlet,
        inlet_velocity=(ini.number("BoundaryCondition", "velocityYR",
                                   default=0.0) +
                        ini.number("BoundaryCondition", "velocityYB",
                                   default=0.0)),
        inlet_velocity_r=ini.number("BoundaryCondition", "velocityYR",
                                    default=0.0),
        inlet_velocity_b=ini.number("BoundaryCondition", "velocityYB",
                                    default=0.0),
        inlet_density_r=ini.number("BoundaryCondition", "densityRH",
                                   default=1.0),
        inlet_density_b=ini.number("BoundaryCondition", "densityBH",
                                   default=0.0),
        outlet_density_r=ini.number("BoundaryCondition", "densityRL",
                                    default=0.0),
        outlet_density_b=ini.number("BoundaryCondition", "densityBL",
                                    default=1.0),
        # optional key, not in the reference dialect: 'no' reproduces the
        # reference's misspelling-gated behavior where the phi outlet
        # repair never fires in the pure CG loops (see CGBoundaryConfig)
        phi_outlet_repair=ini.yesno("BoundaryCondition", "PhiOutletRepair",
                                    default="yes"),
    )
    domain = DomainSpec(
        nx=ini.integer("DomainSize", "xDomain", default=20),
        ny=ini.integer("DomainSize", "yDomain", default=200),
        buffer_layers=ini.integer("DomainSize", "numBufferingLayers",
                                  default=0),
        use_image=ini.yesno("ImageSetup", "Existance", "Exist", default="no"),
    )
    run = RunSpec(
        num_steps=ini.integer("TimeSetup", "TimeSteps", default=1000),
        io_interval=ini.integer("TimeSetup", "TimeInterval", default=1000),
        is_cycle=ini.yesno("CyclesSetup", "IsCycle", default="no"),
        last_step=ini.integer("CyclesSetup", "LastStep", default=0),
    )
    return params, bcs, domain, run


def load_colorgradient3d(path: str):
    """Parse an ``RKtwophasesetup3D.ini``-style file.  Returns
    (ColorGradientParams3D, domain dict nx/ny/nz/use_image, RunSpec, extras)
    with extras the initial densities rho_r / rho_b, the summed inlet
    velocity_z and the CG3DBoundaryConfig under "bcs": a nonzero v_z selects
    the NEBB velocity inlet and the outlet of BoundaryTypeOutlet
    (Convective | FreeFlux -> convective, Dirichlet, else periodic); v_z = 0
    leaves both faces periodic."""
    ini = LegacyIni(path)
    params = ColorGradientParams3D(
        tau_r=ini.number("FluidParameters", "TauR", default=1.0),
        tau_b=ini.number("FluidParameters", "TauB", default=1.0),
        surface_tension=ini.number(
            "SurfaceTension", "SurfaceTension", "SurfaceTensionValue",
            default=0.01),
        contact_angle_deg=ini.number("SurfaceTension", "ContactAngle",
                                     default=90.0),
        beta=ini.number("RKParameters", "BetaThickness", default=0.7),
        delta=ini.number("RKParameters", "DeltaValue", default=0.98),
    )
    domain3d = {
        "nx": ini.integer("DomainSize", "xDomain", default=32),
        "ny": ini.integer("DomainSize", "yDomain", default=32),
        "nz": ini.integer("DomainSize", "zDomain", default=96),
        "use_image": ini.yesno("ImageSetup", "Existance", "Exist",
                               default="no"),
    }
    run = RunSpec(
        num_steps=ini.integer("TimeSteps", "TimeSteps", default=1000),
        io_interval=ini.integer("TimeSteps", "TimeInterval", default=500),
        is_cycle=ini.yesno("CyclesSetup", "IsCycle", default="no"),
        last_step=ini.integer("CyclesSetup", "LastStep", default=0),
    )
    extras = {
        "rho_r": ini.number("FluidParameters", "InitialRhoR", default=1.0),
        "rho_b": ini.number("FluidParameters", "InitialRhoB", default=1.0),
        "velocity_z": (ini.number("BoundaryCondition", "velocityZR",
                                  default=0.0) +
                       ini.number("BoundaryCondition", "velocityZB",
                                  default=0.0)),
    }
    outlet_kind = ini.text("BoundaryCondition", "BoundaryTypeOutlet",
                           default="Convective").strip().lower()
    outlet = {"convective": "convective", "dirichlet": "dirichlet",
              "freeflux": "convective"}.get(outlet_kind, "periodic")
    vz = extras["velocity_z"]
    extras["bcs"] = CG3DBoundaryConfig(
        inlet="velocity" if vz else "periodic",
        outlet=outlet if vz else "periodic",
        inlet_velocity=vz,
        outlet_density=ini.number("BoundaryCondition", "OutletDensity",
                                  default=1.0))
    return params, domain3d, run, extras


def load_transport(path: str, num_default_tracers: int = 1):
    """Parse a ``transportsetup.ini``-style file (the snapshot ships none;
    keys per ``Transport2DRK.py:35-311``)."""
    ini = LegacyIni(path)
    num = ini.integer("TransportParameters", "NumberOfTracers",
                      default=num_default_tracers)
    scheme = ini.integer("TransportParameters", "TransportScheme", default=5)
    relax = ini.text("TransportRelaxation", "Type", default="SRT").upper()
    tau = ini.floats("TransportParameters", "TransportTau",
                     default=",".join(["1.0"] * num))
    j0 = ini.floats("TransportParameters", "DiffusionJ",
                    default=",".join(["0.3333333"] * num))
    reaction = ini.yesno("Reaction", "Option", default="no")
    params = TransportParams(
        num_tracers=num,
        scheme=scheme,
        tau=tuple(tau),
        j0=tuple(j0),
        relaxation="MRT" if relax == "MRT" else "SRT",
        diff_x=ini.floats("TransportMRT", "DiffusionX",
                          default=",".join(["0.1"] * num)),
        diff_y=ini.floats("TransportMRT", "DiffusionY",
                          default=",".join(["0.1"] * num)),
        diff_xy=ini.floats("TransportMRT", "DiffusionXY",
                           default=",".join(["0.0"] * num)),
        diff_yx=ini.floats("TransportMRT", "DiffusionYX",
                           default=",".join(["0.0"] * num)),
        beta_interface=tuple([ini.number("TransportParameters",
                                         "BetaInterface", default=0.0)] * num),
        reaction_rate=ini.number("Reaction", "ReactionRate", default=0.0)
        if reaction else 0.0,
        inlet=ini.text("TransportBoundaries", "InletType",
                       default="none").lower(),
        inlet_conc=ini.floats("TransportBoundaries", "InletConcentration",
                              default=",".join(["1.0"] * num)),
        outlet=ini.text("TransportBoundaries", "OutletType",
                        default="none").lower(),
    )
    return params


def load_shanchen(main_path: str, physics_path: str | None = None):
    """Parse ``twophasesetup.ini`` (model selection) plus the per-scheme
    physics file (``shanchen2D.ini`` / ``efs2D.ini``, found beside it when
    not given).  Returns (ShanChenParams, SCBoundaryConfig, DomainSpec,
    RunSpec, extras) with extras the initial and background densities and
    the duplicate-domain flag."""
    main = LegacyIni(main_path)
    scheme = "EFS" if main.text("InterType", "InteractionType",
                                default="ShanChen").upper() == "EFS" else "SC"
    if physics_path is None:
        physics_path = os.path.join(
            os.path.dirname(main_path),
            "efs2D.ini" if scheme == "EFS" else "shanchen2D.ini")
    phys = LegacyIni(physics_path)

    num_fluids = main.integer("FluidsTypes", "NumberOfFluids", default=2)
    tau = phys.floats("FluidProperties", "FluidsTau")
    sec = "ShanChenParameters" if scheme == "SC" else "EFSParameters"
    g_fluid = phys.floats(sec, "interactionFluid")
    g_solid = phys.floats(sec, "interactionSolid")
    # symmetric G matrix, the upper triangle filled row by row
    g = np.zeros((num_fluids, num_fluids))
    idx = 0
    for i in range(num_fluids - 1):
        for j in range(i + 1, num_fluids):
            g[i, j] = g[j, i] = g_fluid[idx % len(g_fluid)]
            idx += 1
    psi = phys.text(sec, "potentialType", default="Simple")
    body = phys.yesno("BodyForce", "Option", default="no")
    forcing = "shift"
    if scheme == "SC":
        method = phys.text("ForceScheme", "ForcingMethod",
                           default="Shift").lower()
        if method not in ("shift", "guo", "edm"):
            raise ValueError(f"{physics_path}: [ForceScheme] ForcingMethod "
                             f"{method!r}: Shift | Guo | EDM")
        forcing = method
    params = ShanChenParams(
        g_matrix=tuple(map(tuple, g)),
        g_solid=tuple(g_solid),
        tau=tuple(tau),
        scheme=scheme,
        iso_order=phys.integer("ForceScheme", "ExplicitScheme", default=4)
        if scheme == "EFS" else 4,
        collision="MRT" if main.text("RelaxationType", "Type",
                                     default="SRT").upper() == "MRT"
        else "SRT",
        psi="rho" if psi.lower() == "simple" else "PR",
        body_force=(phys.number("BodyForce", "forceXG", default=0.0),
                    phys.number("BodyForce", "forceYG", default=0.0))
        if body else (0.0, 0.0),
        forcing=forcing,
    )
    inlet = _bc_name(phys.text("BoundaryDefinition", "BoundaryTypeInlet",
                               default="periodic"))
    outlet = _bc_name(phys.text("BoundaryDefinition", "BoundaryTypeOutlet",
                                default="periodic"))
    # BoundaryMethod = 'Chang' selects the Chang et al. 2009 corrector rows
    chang = phys.text("BoundaryDefinition", "BoundaryMethod",
                      default="ZouHe").lower() == "chang"
    inlet_map = {"neumann": "chang_velocity" if chang else "zou_he_velocity",
                 "dirichlet": "chang_pressure" if chang else "zou_he_pressure",
                 "periodic": "periodic"}
    outlet_map = {"dirichlet": "chang_pressure" if chang else "zou_he_pressure",
                  "convective": "convective",
                  "convective_average": "convective",
                  "periodic": "periodic"}
    bcs = SCBoundaryConfig(
        inlet=inlet_map.get(inlet, "periodic"),
        outlet=outlet_map.get(outlet, "periodic"),
        inlet_velocity=phys.floats("VelocityBoundary", "velocityY",
                                   default="0.0"),
        inlet_density=phys.floats("PressureBoundary", "PressureInlet",
                                  default="1.0"),
        outlet_density=phys.floats("PressureBoundary", "PressureOutlet",
                                   default="1.0"),
    )
    domain = DomainSpec(
        nx=main.integer("SeparationBorder", "xGrid", default=32),
        ny=main.integer("SeparationBorder", "yGrid", default=200),
        use_image=main.yesno("PictureSetup", "Exist", default="no"),
    )
    run = RunSpec(
        num_steps=phys.integer("Time", "numberTimeStep", default=1000),
        io_interval=1000,
        is_cycle=main.yesno("DICycles", "Option", default="no"),
        last_step=main.integer("DICycles", "LastStep", default=0),
    )
    extras = {
        "initial_densities": phys.floats("FluidProperties",
                                         "InitialDensities"),
        "background_densities": phys.floats("FluidProperties",
                                            "BackgroundDensities"),
        "duplicate": main.yesno("DuplicateDomain", "Option", default="no"),
    }
    return params, bcs, domain, run, extras


def load_shanchen3d(path: str):
    """Parse a 3-D Shan-Chen INI (configs/shanchen3d.ini: the 2-D
    shanchen2D.ini / twophasesetup.ini key names plus DomainSize.zDomain).
    Returns (ShanChenParams3D, domain dict nx/ny/nz, RunSpec, extras) with
    extras the initial and background densities and the droplet radius."""
    ini = LegacyIni(path)
    num_fluids = ini.integer("FluidsTypes", "NumberOfFluids", default=2)
    tau = ini.floats("FluidProperties", "FluidsTau", default="1.0,1.0")
    g_fluid = ini.floats("ShanChenParameters", "interactionFluid",
                         default="3.6")
    g_solid = ini.floats("ShanChenParameters", "interactionSolid",
                         default=",".join(["0.0"] * num_fluids))
    # symmetric G matrix, the upper triangle filled row by row
    g = np.zeros((num_fluids, num_fluids))
    idx = 0
    for i in range(num_fluids - 1):
        for j in range(i + 1, num_fluids):
            g[i, j] = g[j, i] = g_fluid[idx % len(g_fluid)]
            idx += 1
    body = ini.yesno("BodyForce", "Option", default="no")
    params = ShanChenParams3D(
        g_matrix=tuple(map(tuple, g)),
        g_solid=tuple(g_solid),
        tau=tuple(tau),
        body_force=(ini.number("BodyForce", "forceXG", default=0.0),
                    ini.number("BodyForce", "forceYG", default=0.0),
                    ini.number("BodyForce", "forceZG", default=0.0))
        if body else (0.0, 0.0, 0.0),
    )
    domain3d = {
        "nx": ini.integer("DomainSize", "xDomain", default=32),
        "ny": ini.integer("DomainSize", "yDomain", default=32),
        "nz": ini.integer("DomainSize", "zDomain", default=64),
    }
    run = RunSpec(
        num_steps=ini.integer("Time", "numberTimeStep", default=1000),
        io_interval=ini.integer("Time", "TimeInterval", default=500),
    )
    extras = {
        "initial_densities": ini.floats("FluidProperties",
                                        "InitialDensities",
                                        default="1.0,1.0"),
        "background_densities": ini.floats("FluidProperties",
                                           "BackgroundDensities",
                                           default="0.02,0.02"),
        "radius": ini.number("InitialCondition", "DropletRadius",
                             default=8.0),
    }
    return params, domain3d, run, extras


def _time(ini):
    """(num_steps, io_interval) of a basicsetup-style [Time] section:
    TimeLength / TimeStep steps, output every TimeInterval (default a tenth
    of the run)."""
    t_len = ini.number("Time", "TimeLength", default="1000")
    t_step = ini.number("Time", "TimeStep", default="1.0")
    num_steps = max(1, int(round(t_len / max(t_step, 1e-30))))
    io = ini.integer("Time", "TimeInterval",
                     default=str(max(1, num_steps // 10)))
    return num_steps, io


def load_basic3d(path: str):
    """Parse a 3-D single-phase INI (configs/basic3d.ini: basicsetup.ini's
    keys plus Geometry.nz).  Returns (solver_kw, domain dict nx/ny/nz,
    RunSpec) with solver_kw feeding ``SinglePhaseD3Q19`` (tau, collision SRT
    or TRT, the body force gValue along z)."""
    ini = LegacyIni(path)
    domain3d = {
        "nx": ini.integer("Geometry", "nx", default=32),
        "ny": ini.integer("Geometry", "ny", default=32),
        "nz": ini.integer("Geometry", "nz", default=64),
    }
    num_steps, io = _time(ini)
    collision = ini.text("Scheme", "Type", default="SRT").upper()
    if collision not in ("SRT", "TRT"):
        collision = "SRT"
    solver_kw = dict(
        tau=ini.number("FluidParameters", "Tau", default="1.0"),
        collision=collision,
        body_force=(0.0, 0.0,
                    ini.number("BodyForce", "gValue", default="0.0")),
    )
    return solver_kw, domain3d, RunSpec(num_steps=num_steps, io_interval=io)


def load_basic(path: str):
    """Parse a ``basicsetup.ini``-style file (the reference's BasicD2Q9
    keys).  Returns ``(solver_kw, u0, domain_extents, DomainSpec, RunSpec)``
    with ``solver_kw`` feeding ``SinglePhaseD2Q9`` (tau, collision, the body
    force gValue along y) and ``domain_extents = ((x0, x1), (y0, y1))`` the
    fluid region (cells outside it are solid)."""
    ini = LegacyIni(path)
    nx = ini.integer("Geometry", "nx")
    ny = ini.integer("Geometry", "ny")
    num_steps, io = _time(ini)
    collision = ini.text("Scheme", "Type", default="SRT").upper()
    if collision not in ("SRT", "TRT", "MRT"):
        collision = "SRT"
    solver_kw = dict(
        tau=ini.number("FluidParameters", "Tau", default="1.0"),
        collision=collision,
        body_force=(0.0, ini.number("BodyForce", "gValue", default="0.0")),
    )
    u0 = (ini.number("InitialCondition", "VelocityXLB", default="0.0"),
          ini.number("InitialCondition", "VelocityYLB", default="0.0"))
    xdom = ini.floats("FlowDomain", "xDomain", default=f"0,{nx - 1}")
    ydom = ini.floats("FlowDomain", "yDomain", default=f"0,{ny - 1}")
    extents = ((int(xdom[0]), int(xdom[-1])), (int(ydom[0]), int(ydom[-1])))
    return (solver_kw, u0, extents, DomainSpec(nx=nx, ny=ny),
            RunSpec(num_steps=num_steps, io_interval=io))
