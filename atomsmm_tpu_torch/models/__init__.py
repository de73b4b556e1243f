"""Model systems (counterpart of atomsmm_tpu/models)."""
from .argon import argon_system
from .ionic_liquid import ionic_liquid_system
from .phenol import phenol_in_water
from .water import water_system
