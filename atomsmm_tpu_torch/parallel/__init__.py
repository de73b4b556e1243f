"""Replicas, replica exchange and spatial decomposition, on one card or
over the ranks of a torch.distributed device mesh (counterpart of
atomsmm_tpu/parallel)."""
from .hrex import HREXSampler, hrex_sample_lambda_states, make_hrex_swap
from .mesh import SpatialContext, active_spatial_mesh, spatial_mesh
from .replicas import make_replicated_step, replicate_state
from .spatial import (
    sharded_cell_pair_energy,
    sharded_cell_pair_energy_forces,
    sharded_pme_reciprocal_energy,
    sharded_pme_reciprocal_energy_fft,
)
