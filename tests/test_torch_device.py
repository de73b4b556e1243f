"""The port's entry points build on the CUDA card unless the caller asks for
another device: without a card and without `device` they raise, naming the
missing card and the way to the CPU; with a card (marker ``cuda``) they
return CUDA tensors. They never build on the CPU unasked."""
import numpy as np
import pytest
import torch

from atomsmm_tpu_torch.interop import (
    describe_reference,
    state_from_numpy,
    system_from_numpy,
)
from atomsmm_tpu_torch.models import (
    argon_system,
    ionic_liquid_system,
    water_system,
)
from atomsmm_tpu_torch.ops.neighbors import make_neighbor_spec
from atomsmm_tpu_torch.ops.tilepair import make_tilepair_spec
from atomsmm_tpu_torch.system import make_exclusions_array

BOX = np.full(3, 2.0)


def _desc():
    system, _, _ = water_system(n_molecules=8, r_cut=0.3, r_switch=0.25,
                                device="cpu")
    return describe_reference(system)


# entry point -> a call without `device`, and the tensor it built
ENTRY_POINTS = {
    "water_system": lambda: water_system(n_molecules=8, r_cut=0.3,
                                         r_switch=0.25, neighbors=True)[1],
    "argon_system": lambda: argon_system(n=64, r_cut=0.3, r_switch=0.25,
                                         neighbors=True)[1],
    "ionic_liquid_system": lambda: ionic_liquid_system(
        n_pairs=24, r_cut=0.65, r_switch=0.55, neighbors=True)[1],
    "system_from_numpy": lambda: system_from_numpy(_desc()).masses,
    "state_from_numpy": lambda: state_from_numpy(
        {"x": np.zeros((4, 3)), "v": np.zeros((4, 3)), "box": BOX}).x,
    "make_exclusions_array": lambda: make_exclusions_array(4, [(0, 1)]),
    "make_neighbor_spec": lambda: make_neighbor_spec(BOX, 200, 0.5).nbr_cells,
    "make_tilepair_spec": lambda: make_tilepair_spec(BOX, 200, 0.5).excbits,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_a_card_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: see the cuda-marked test")
    with pytest.raises(RuntimeError, match='no CUDA card.*device="cpu"'):
        ENTRY_POINTS[name]()


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_builds_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    assert ENTRY_POINTS[name]().is_cuda


def test_system_built_on_the_cpu_when_asked():
    system, x, box = water_system(n_molecules=8, r_cut=0.3, r_switch=0.25,
                                  neighbors=True, device="cpu")
    assert x.device.type == box.device.type == "cpu"
    assert system.masses.device.type == "cpu"
    assert system.neighbors.nbr_cells.device.type == "cpu"
    assert system.forces[0].exclusions.device.type == "cpu"
