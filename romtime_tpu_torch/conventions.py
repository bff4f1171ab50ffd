"""Shared vocabulary: string constants used as configuration and storage
keys. Counterpart of ``romtime_tpu/conventions.py``; the values are
identical because persisted artifacts (npz keys, pickle names, CSV
headers) depend on them. Only the namespaces the port reads are carried
over.
"""

#: ``savefig`` keywords of every saved plot.
FIG_KWARGS = dict(dpi=300, bbox_inches="tight")


class ProblemType:
    FOM = "fom"
    ROM = "rom"
    SROM = "srom"
    HROM = "hrom"


class OperatorType(ProblemType):
    MASS = "mass"
    STIFFNESS = "stiffness"
    CONVECTION = "convection"
    TRILINEAR = "trilinear"
    NONLINEAR = "nonlinear"
    NONLINEAR_LIFTING = "nonlinear-lifting"
    FORCING = "forcing"
    LIFTING = "lifting"
    RHS = "rhs"
    REDUCED_BASIS = "reduced-basis"


class Stage:
    OFFLINE = "offline"
    VALIDATION = "validation"
    ONLINE = "online"


class BDF:
    ONE = "1"
    TWO = "2"


class Domain:
    NX = "nx"
    NT = "nt"
    T = "T"
    L0 = "L0"


class BoundaryConditions:
    B0 = "b0"
    BL = "bL"
    DB0_DT = "db0_dt"
    DBL_DT = "dbL_dt"


class Treewalk:
    """Report keys of the POD tree walk (reference ``conventions.py:71``)."""

    BASIS_AFTER_WALK = "basis-shape-after-tree-walk"
    BASIS_FINAL = "basis-shape-final"
    BASIS_TIME = "basis-shape-time"
    ENERGY_MU = "energy-mu"
    ENERGY_TIME = "energy-time"
    SPECTRUM_MU = "spectrum-mu"
    SPECTRUM_TIME = "spectrum-time"


class TreewalkNonlinear:
    """Report keys of the nonlinear-operator tree walk (reference
    ``conventions.py:83``)."""

    BASIS_AFTER_WALK = "N-basis-shape-after-tree-walk"
    BASIS_FINAL = "N-basis-shape-final"
    BASIS_TIME = "N-basis-shape-time"
    ENERGY_MU = "N-energy-mu"
    ENERGY_TIME = "N-energy-time"
    SPECTRUM_MU = "N-spectrum-mu"
    SPECTRUM_TIME = "N-spectrum-time"


class EmpiricalInterpolation:
    """Hyper-reduction flavours (reference ``conventions.py:96``); also
    the type part of a collateral basis' pickle name."""

    DEIM = "DEIM"
    MDEIM = "MDEIM"
    NONLINEAR = "N-MDEIM"


class RomParameters:
    """ROM and tree-walk configuration keys (reference
    ``conventions.py:104``)."""

    NUM_SNAPSHOTS = "num_snapshots"
    NUM_MU = "num_mu"
    NUM_TIME = "num_time"
    NUM_BASIS = "num_phi"
    TOL_MU = "tol_mu"
    TOL_TIME = "tol_time"
    TOL_BASIS = "tol_phi"
    TS = "ts"
    WEIGHTED_POD = "weighted_pod"

    NUM_ONLINE = "num_online"

    SROM_TRUNCATE = "srom_truncate"
    SROM_KEEP = "srom_num"

    NMDEIM_SIZE = "mdeim_truncate"


class PistonParameters:
    A0 = "a0"
    ALPHA = "alpha"
    DELTA = "delta"
    GAMMA = "gamma"
    OMEGA = "omega"

    MACH_PISTON = "piston_mach"
    NONLINEARITY = "eta"


class OneDimensionalBurgersConventions:
    """Piston μ names (reference ``fom/nonlinear.py:30-35``)."""

    A0 = "a0"
    DELTA = "delta"
    GAMMA = "gamma"
    ALPHA = "alpha"


class MassConservation:
    """Mass conservation report keys (reference ``conventions.py:146-153``)."""

    WHICH = "which"
    TIMESTEPS = "timesteps"
    MASS = "mass"
    MASS_CHANGE = "mass_change"
    OUTFLOW = "outflow"


class ProbeLocations:
    """Probe naming (reference ``conventions.py:167-172``)."""

    OUTFLOW = "outflow"
    MIDDLE = "halfway"
    PISTON = "piston"


class SolutionsStorageNames:
    """Solution storage attributes (reference ``base.py:14-22``)."""

    DOMAIN = "domain"
    FOM = "fom"
    MU = "mu"
    ROM = "rom"
    SNAPSHOTS = "snapshots"
    TIMESTEPS = "ts"


class Errors(ProblemType):
    """Error report keys (reference ``conventions.py:156-164``)."""

    SACRIFICIAL = "sacrificial"
    ESTIMATOR = "estimator"

    AVERAGE_ROM = "rom_average"
    AVERAGE_ESTIMATOR = "estimator_average"
    AVERAGE_SACRIFICIAL = "srom_average"


class StorageNames:
    ROM = "basis_rom.pkl"
    SROM = "basis_srom.pkl"

    VALIDATION_SOLUTIONS = "validation_solutions.pkl"
    SETUP = "setup.json"
    MU_SPACE = "mu_space.json"
    MU_SPACE_DEIM = "mu_space_deim.json"

    WINDOWS = "windowed_serving.npz"
    WINDOWS_SROM = "windowed_serving_srom.npz"
    WINDOWS_MULOCAL = "windowed_serving_mulocal.npz"
    MULOCAL_SNAPSHOTS = "mulocal_snapshots.npz"
    SNAPSHOTS = "offline_snapshots.npz"
