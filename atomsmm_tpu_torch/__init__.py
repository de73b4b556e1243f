"""atomsmm_tpu_torch — the PyTorch/CUDA port of atomsmm_tpu.

The JAX package `atomsmm_tpu` stays the reference; this package keeps its
module layout and public names. It runs in float64 on the CPU (the parity
tests) and in float32 on an NVIDIA Hopper GPU, where the nonbonded sweeps
are hand-written CUDA kernels: csrc/half_pair.cu (Newton half stencil),
csrc/cell_pair.cu (full stencil, small boxes) and csrc/tile_pair.cu (the
standalone tile-list entry point, ops/tilepair.py). The PME reciprocal sum
(ops/pme.py) is PyTorch: a scatter, torch.fft and a gather. The
alchemical machinery (alchemy.py: multi-state energies, MBAR, TI, the
solvation free energy) runs its softcore forms on the same kernels. A
MonteCarloBarostat in a system moves the box (integrate/barostat.py), and
computers.py gives virials and pressures, from the kernels' virial form on
the cell path. Rigid water holds its geometry by SETTLE (ops/settle.py) or
SHAKE/RATTLE (ops/constraints.py), TIP4P/Ew's M site is a virtual site
(ops/virtual_sites.py), and HydrogenMassRepartitionedSystem moves mass
onto the hydrogens. SWM4-NDP water is polarizable through Drude
oscillators (ops/drude.py, integrate/drude.py: extended-Lagrangian and
SCF dynamics); CMAP (ops/cmap.py) and harmonic impropers complete the
CHARMM bonded terms. This package never imports JAX.
"""

__version__ = "0.1.0"

from . import units
from .alchemy import (
    mbar_free_energies,
    multistate_energies,
    reduced_energy_matrix,
    ti_gradient,
)
from .computers import PressureComputer
from .context import Context, StateSnapshot
from .forces import (
    CMAPTorsionForce,
    CustomBondForce,
    CustomNonbondedForce,
    DampedSmoothedForce,
    DrudeForce,
    FarNonbondedForce,
    HarmonicAngleForce,
    HarmonicBondForce,
    HarmonicImproperForce,
    MonteCarloBarostat,
    NearNonbondedForce,
    NonbondedExceptionsForce,
    NonbondedForce,
    PeriodicTorsionForce,
    PMEReciprocalForce,
    SoftcoreLennardJonesForce,
    TemplateBondedForce,
)
from .integrate.drude import (
    DrudeLangevinIntegrator,
    DrudeOrnsteinUhlenbeckPropagator,
    DrudeSCFIntegrator,
)
from .integrate.integrators import (
    GlobalThermostatIntegrator,
    Integrator,
    LangevinMiddleIntegrator,
    MultipleTimeScaleIntegrator,
    PropagatorIntegrator,
    VelocityVerletIntegrator,
)
from .integrate.propagators import (
    BoostPropagator,
    ChainedPropagator,
    GenericBoostPropagator,
    GenericScalingPropagator,
    NoseHooverChainPropagator,
    OrnsteinUhlenbeckPropagator,
    Propagator,
    RespaPropagator,
    SplitPropagator,
    SuzukiYoshidaPropagator,
    TranslationPropagator,
    TrotterSuzukiPropagator,
    VelocityRescalingPropagator,
    VelocityVerletPropagator,
)
from .integrate.sinr import (
    IsokineticBoostPropagator,
    MassiveNoseHooverLangevinPropagator,
    MassiveNoseHooverPropagator,
    NHL_R_Integrator,
    SIN_R_Integrator,
    SINRThermostatPropagator,
)
from .potential import (
    force_fn,
    group_energies,
    potential_energy,
    split_potential_energy,
)
from .state import (
    State,
    kinetic_energy,
    make_state,
    maxwell_boltzmann_velocities,
    remove_com_motion,
)
from .system import System, make_exclusions_array
from .systems import (
    AlchemicalRespaSystem,
    HydrogenMassRepartitionedSystem,
    RESPASystem,
    SolvationSystem,
)
from .utils import (
    InputError,
    count_degrees_of_freedom,
    find_nonbonded_force,
    hijack_force,
)
