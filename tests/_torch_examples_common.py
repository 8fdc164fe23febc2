"""Shared set-up of the port's example tests (``test_torch_examples*.py``):
loading an example file as a module, the JAX examples' Fed-RAC engine, and
the set-up comparison."""
import importlib.util
import pathlib

from repro.core import server as j_srv
from repro.core.families import cnn_family as j_cnn_family
from repro.core.resources import TABLE_III as J_TABLE_III
from repro.core.resources import participants_from_matrix as j_parts
from repro.data.partition import dirichlet_partition as j_dirichlet
from repro.data.synthetic import (make_classification as j_make,
                                  train_test_split as j_split)

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def load_example(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_engine(samples, seed, data_seed, rounds, **fam):
    """The JAX examples' federation: synth-mnist, 40 Table-III
    participants, Dirichlet(1.0), ``compact_to=4``."""
    train, _ = j_split(j_make("synth-mnist", samples, seed=data_seed))
    idx = j_dirichlet(train.y, 40, alpha=1.0, seed=data_seed)
    parts = j_parts(J_TABLE_III, n_data=[len(p) for p in idx])
    cd = [{"x": train.x[p], "y": train.y[p]} for p in idx]
    return j_srv.FedRAC(parts, cd, j_cnn_family(classes=10, in_channels=1,
                                                **fam),
                        j_srv.FLConfig(rounds=rounds, compact_to=4,
                                       seed=seed), classes=10).setup()


def assert_same_setup(j, t):
    assert t.k_optimal == j.k_optimal
    assert t.di_values == j.di_values
    assert t.m == j.m
    assert t.assignment.members == j.assignment.members
    assert t.assignment.n_eff == j.assignment.n_eff
    assert t.assignment.tau == j.assignment.tau
