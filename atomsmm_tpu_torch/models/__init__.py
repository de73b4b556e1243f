"""Model systems (counterpart of atomsmm_tpu/models)."""
from .argon import argon_system
from .ionic_liquid import ionic_liquid_system
from .water import water_system
