"""Replicas and replica exchange on one card (counterpart of
atomsmm_tpu/parallel). The JAX package's spatial decomposition
(parallel/spatial.py, parallel/mesh.py) is ROADMAP item 14b."""
from .hrex import HREXSampler, hrex_sample_lambda_states, make_hrex_swap
from .replicas import make_replicated_step, replicate_state
