"""Shared vocabulary: string constants used as configuration and storage
keys. Counterpart of ``romtime_tpu/conventions.py``; the values are
identical because persisted artifacts (npz keys, pickle names, CSV
headers) depend on them. Only the namespaces the port reads are carried
over.
"""


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
