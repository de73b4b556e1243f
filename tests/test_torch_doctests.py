"""Docstring examples of the port run as tests, module by module (the
counterpart of tests/test_doctests.py for atomsmm_tpu_torch)."""
import doctest
import importlib

import pytest

MODULES = {
    "alchemy": 5,
    "app": 10,
    "checkpoint": 9,
    "computers": 3,
    "forces": 1,
    "integrate.barostat": 3,
    "integrate.drude": 2,
    "integrate.integrators": 3,
    "integrate.propagators": 3,
    "integrate.sinr": 2,
    "io.amber": 11,
    "io.pdb": 7,
    "minimize": 6,
    "models.water": 12,
    "ops.cmap": 10,
    "ops.constraints": 10,
    "ops.drude": 9,
    "ops.pairfuncs": 12,
    "ops.pairtrace": 8,
    "ops.pbc": 7,
    "ops.pme": 3,
    "parallel.replicas": 6,
    "profiling": 6,
    "ops.settle": 17,
    "ops.switching": 8,
    "state": 4,
    "system": 3,
    "systems": 21,
    "utils": 2,
    "ops.virtual_sites": 12,
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_doctests(name):
    module = importlib.import_module(f"atomsmm_tpu_torch.{name}")
    result = doctest.testmod(module, verbose=False)
    assert result.failed == 0, f"{name}: {result.failed} doctest failures"
    assert result.attempted >= MODULES[name], (name, result.attempted)
