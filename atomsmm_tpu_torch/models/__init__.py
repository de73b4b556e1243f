"""Model systems (counterpart of atomsmm_tpu/models)."""
from .argon import argon_system
from .ionic_liquid import ionic_liquid_system
from .phenol import phenol_in_water
from .water import (
    rigid_water_system,
    swm4_water_system,
    tip4p_water_system,
    water_system,
)
