"""The port does what the JAX package does: every module of
``src/repro/`` has a port file at the same path under
``src/repro_torch/``, and every public top-level function or class of a
module the two share has a same-named counterpart in the port's.  Read
from the source with ``ast``, importing neither package.

A Pallas kernel module (``kernels/<k>/kernel.py``) is ported as a CUDA
source (``kernels/<k>/csrc/<k>.cu``) whose wrapper module
(``kernels/<k>/ops.py``) holds the kernel function's counterpart.  The
exceptions below are XLA's or JAX's alone, each with its reason.
"""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "src", "repro")
PORT_PKG = os.path.join(ROOT, "src", "repro_torch")
EXCEPTIONS = {
    # GSPMD's sharding-constraint hint; the port has no partitioner and
    # calls Megatron's operations at the cut points (models/tp.py)
    ("models/tp.py", "shard_hint"),
    # the JAX sampler's threefry round key; the port's stream is
    # splitmix64 by design, keyed on (seed, round, slot)
    ("data/device_sampler.py", "round_key"),
}


def _modules():
    out = []
    for root, _, files in os.walk(JAX_PKG):
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(root, f), JAX_PKG))
    return sorted(out)


def _port_file(rel: str) -> str:
    """The port file of a JAX module (a Pallas kernel's CUDA source)."""
    parts = rel.split(os.sep)
    if parts[0] == "kernels" and parts[-1] == "kernel.py":
        return os.path.join("kernels", parts[1], "csrc", parts[1] + ".cu")
    return rel


def _port_module(rel: str) -> str:
    """The port module holding a JAX module's public names."""
    parts = rel.split(os.sep)
    if parts[0] == "kernels" and parts[-1] == "kernel.py":
        return os.path.join("kernels", parts[1], "ops.py")
    return rel


def _public(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))
            and not n.name.startswith("_")}


MODULES = _modules()


def test_the_walk_finds_the_packages():
    assert len(MODULES) > 50
    assert "launch/dryrun.py" in MODULES


@pytest.mark.parametrize("rel", MODULES)
def test_every_module_has_a_port_file(rel):
    assert os.path.exists(os.path.join(PORT_PKG, _port_file(rel))), rel


@pytest.mark.parametrize("rel", MODULES)
def test_every_public_name_has_a_counterpart(rel):
    want = _public(os.path.join(JAX_PKG, rel))
    have = _public(os.path.join(PORT_PKG, _port_module(rel)))
    missing = {n for n in want - have if (rel, n) not in EXCEPTIONS}
    assert not missing, f"{rel}: {sorted(missing)}"


def test_every_exception_names_a_jax_public_name_the_port_lacks():
    for rel, name in EXCEPTIONS:
        assert name in _public(os.path.join(JAX_PKG, rel))
        assert name not in _public(os.path.join(PORT_PKG, rel))
