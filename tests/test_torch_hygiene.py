"""The port stands alone: no module of ``src/repro_torch``, no port example
(``examples/torch_*.py``) and not ``chip_smoke.py`` imports JAX, the JAX
package, ``msgpack`` (which the card's machine lacks: the port writes the
checkpoint format itself) or ``ml_dtypes`` (the port reads and writes bf16
checkpoint leaves without it), and the engine never falls back to the CPU
when no card is there."""
import ast
import pathlib

import pytest
import torch

from repro_torch.core import server as t_srv
from repro_torch.core.families import mlp_family
from repro_torch.launch import fl_train

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack", "ml_dtypes")


def _port_files():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    examples = sorted((REPO / "examples").glob("torch_*.py"))
    return files + examples + [REPO / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_module_imports_no_jax_or_repro(path):
    assert path.exists(), path
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_engine_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_srv.FedRAC([], [], mlp_family(), t_srv.FLConfig(), classes=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_srv.FedRAC([], [], mlp_family(), t_srv.FLConfig(), classes=10,
                     device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fl_train.main(["--participants", "4", "--rounds", "1",
                       "--samples", "100", "--base-width", "0.125"])
    eng = t_srv.FedRAC([], [], mlp_family(), t_srv.FLConfig(), classes=10,
                       device="cpu")
    assert eng.device == torch.device("cpu")
