"""The port's public surface against the JAX package's, read from the
source with `ast` (neither package is imported).

Every public function, class and method of each module of atomsmm_tpu/
must have a counterpart of the same name in the module of the same path
under atomsmm_tpu_torch/ (defined there, or bound there by an import or an
assignment), or an entry in DO_NOT_PORT below with the reason it is not
ported. No reason may rest on a speed measurement: what the port leaves
out, it leaves out because the function has no work to do on the card.
"""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "atomsmm_tpu"
PORT_PKG = ROOT / "atomsmm_tpu_torch"

_SPREAD = ("block-binned PME spreading and its stale-bucket machinery: the "
           "port spreads every atom's stencil by a scatter-add at each "
           "evaluation, so there is no spread bucket to build, age, check "
           "or resize")

#: "module path:name" (or "module path:*" for a whole module) -> reason
DO_NOT_PORT = {
    "forces.py:pme_spread_extras": _SPREAD,
    "forces.py:pme_spread_stale_flags": _SPREAD,
    "forces.py:retune_pme_spread": _SPREAD,
    "forces.py:update_pme_spread": _SPREAD,
    "ops/pme.py:build_spread_bucket": _SPREAD,
    "ops/pme.py:choose_spread_blocks": _SPREAD,
    "ops/pme.py:spread_block_overflow": _SPREAD,
    "ops/pme.py:spread_bucket_rebuild_trigger": _SPREAD,
    "ops/pme.py:spread_charges_blocked": _SPREAD,
    "ops/pme.py:spread_charges_stale": _SPREAD,
    "ops/pme.py:spread_stale_exceeded": _SPREAD,
    "ops/blocks.py:block_pair_sums": (
        "its counterpart is block_pair_plain, the plain twin of the "
        "block kernel (csrc/block_pair.cu), which returns the kernel's "
        "per-atom rows instead of sums in sorted space"),
    "ops/pairfuncs.py:erfc_approx": (
        "a polynomial erfc for kernels without one; CUDA has erfc and "
        "erfcf, which csrc/pair_forms.cuh calls"),
    "ops/pairfuncs.py:kernel_safe_math": (
        "switches the pair functions to the polynomial erfc inside a "
        "traced kernel; the CUDA kernels evaluate built-in forms"),
    "ops/pallas_pair.py:*": (
        "the staging and launch of the Pallas cell-pair kernels; their "
        "CUDA counterparts (csrc/half_pair.cu, csrc/cell_pair.cu) are "
        "staged and launched by ops/pair_kernel.py"),
    "ops/tilepair.py:TilePairSpec.backend": (
        "a backend switch; in the port the device of the spec's tensors "
        "decides where the sweep runs"),
    "utils.py:pytree_dataclass": (
        "registers a dataclass as a JAX pytree for jit; the port's specs "
        "and forces are plain dataclasses, PyTorch running eagerly"),
    "utils.py:static_field": (
        "marks a pytree field as static for jit; plain dataclasses need "
        "no such mark"),
}


def _public(path: pathlib.Path):
    """Public top-level functions and classes of a module, and the public
    methods defined in each class's body as 'Class.method'."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and not node.name.startswith("_"):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out.update(
                    f"{node.name}.{sub.name}" for sub in node.body
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))
                    and not sub.name.startswith("_"))
    return out


def _bound(path: pathlib.Path):
    """Everything a module defines or binds: its public surface as
    _public reads it, and every name a top-level import or assignment
    binds (re-exports, aliases)."""
    out = _public(path)
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom) or isinstance(node, ast.Import):
            out.update((a.asname or a.name).split(".")[0]
                       for a in node.names)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets
                       if isinstance(t, ast.Name))
    return out


MODULES = sorted(str(p.relative_to(JAX_PKG))
                 for p in JAX_PKG.rglob("*.py"))


def test_the_jax_package_is_read():
    assert "forces.py" in MODULES and "ops/blocks.py" in MODULES
    assert "Force.uses_neighbors" in _public(JAX_PKG / "forces.py")


@pytest.mark.parametrize("module", MODULES)
def test_every_public_name_has_a_counterpart(module):
    names = _public(JAX_PKG / module)
    port = PORT_PKG / module
    if f"{module}:*" in DO_NOT_PORT:
        assert not port.exists(), (
            f"{module} is on the do-not-port list but has a port file")
        return
    assert port.exists(), f"no port of {module}"
    have = _bound(port)
    missing = sorted(name for name in names
                     if name not in have
                     and f"{module}:{name}" not in DO_NOT_PORT)
    assert not missing, f"{module}: no counterpart in the port: {missing}"


def test_do_not_port_entries_are_current_and_give_reasons():
    """Each entry names a JAX public name the port lacks, and its reason
    cites no timing."""
    for key, reason in DO_NOT_PORT.items():
        module, name = key.split(":")
        assert name == "*" or name in _public(JAX_PKG / module), key
        if name != "*":
            assert name not in _bound(PORT_PKG / module), (
                f"{key} is ported: take it off the list")
        assert len(reason) > 40, key
        for word in ("TPU", "measured", "faster", "slower", "×", " ms",
                     "worse"):
            assert word not in reason, (key, word)
