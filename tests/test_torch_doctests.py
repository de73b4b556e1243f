"""Docstring examples of the port run as tests, module by module (the
counterpart of tests/test_doctests.py for atomsmm_tpu_torch)."""
import doctest
import importlib

import pytest

MODULES = {
    "alchemy": 5,
    "forces": 1,
    "integrate.integrators": 3,
    "integrate.propagators": 3,
    "integrate.sinr": 2,
    "ops.pairfuncs": 1,
    "ops.pbc": 3,
    "ops.pme": 3,
    "ops.switching": 3,
    "state": 4,
    "systems": 3,
    "utils": 2,
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_doctests(name):
    module = importlib.import_module(f"atomsmm_tpu_torch.{name}")
    result = doctest.testmod(module, verbose=False)
    assert result.failed == 0, f"{name}: {result.failed} doctest failures"
    assert result.attempted >= MODULES[name], (name, result.attempted)
