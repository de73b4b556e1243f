"""atomsmm_tpu_torch — the PyTorch/CUDA port of atomsmm_tpu.

The JAX package `atomsmm_tpu` stays the reference; this package keeps its
module layout and public names. It runs in float64 on the CPU (the parity
tests) and in float32 on an NVIDIA Hopper GPU, where the nonbonded sweeps
are hand-written CUDA kernels: csrc/half_pair.cu (Newton half stencil),
csrc/cell_pair.cu (full stencil, small boxes) and csrc/tile_pair.cu (the
standalone tile-list entry point, ops/tilepair.py). This package never
imports JAX.
"""

__version__ = "0.1.0"

from . import units
from .context import Context, StateSnapshot
from .forces import (
    FarNonbondedForce,
    HarmonicAngleForce,
    HarmonicBondForce,
    NearNonbondedForce,
    NonbondedForce,
    TemplateBondedForce,
)
from .integrate.integrators import (
    Integrator,
    MultipleTimeScaleIntegrator,
    VelocityVerletIntegrator,
)
from .integrate.propagators import (
    BoostPropagator,
    NoseHooverChainPropagator,
    Propagator,
    RespaPropagator,
    TranslationPropagator,
    VelocityVerletPropagator,
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
from .utils import InputError, count_degrees_of_freedom, find_nonbonded_force
