"""atomsmm_tpu_torch — the PyTorch/CUDA port of atomsmm_tpu.

The JAX package `atomsmm_tpu` stays the reference; this package keeps its
module layout and public names. It runs in float64 on the CPU (the parity
tests) and in float32 on an NVIDIA Hopper GPU, where the nonbonded sweeps
are hand-written CUDA kernels: csrc/half_pair.cu (Newton half stencil),
csrc/cell_pair.cu (full stencil, small boxes) and csrc/tile_pair.cu (the
standalone tile-list entry point, ops/tilepair.py). The PME reciprocal sum
(ops/pme.py) is PyTorch: a scatter, torch.fft and a gather. This package
never imports JAX.
"""

__version__ = "0.1.0"

from . import units
from .context import Context, StateSnapshot
from .forces import (
    FarNonbondedForce,
    HarmonicAngleForce,
    HarmonicBondForce,
    NearNonbondedForce,
    NonbondedExceptionsForce,
    NonbondedForce,
    PeriodicTorsionForce,
    PMEReciprocalForce,
    TemplateBondedForce,
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
from .systems import RESPASystem
from .utils import (
    InputError,
    count_degrees_of_freedom,
    find_nonbonded_force,
    hijack_force,
)
