"""The port's three examples on the CPU (``examples/torch_*.py``).

Each example's set-up (Procedures 1 and 2 on its federation) agrees with
its JAX example's on ``k_optimal``, the Dunn indices and the assignment;
then the example runs end to end with ``--device cpu``.  Without a card and
without ``--device cpu`` an example raises.  The paper driver
(``torch_fedrac_cnn_full.py``) is ``tests/test_torch_examples_paper.py``.
"""
import pytest
import torch

from _torch_examples_common import assert_same_setup, jax_engine, load_example
from _torch_threads import one_torch_thread  # noqa: F401

from repro.launch import sim_run as j_sim_run

from repro_torch.launch import sim_run as t_sim_run


def test_quickstart_setup_matches_jax_and_runs(capsys):
    ex = load_example("torch_quickstart")
    t, _ = ex.build("cpu")
    # examples/quickstart.py: 2400 samples at data seed 0, FLConfig seed 3
    assert_same_setup(jax_engine(2400, 3, 0, 8), t)
    res = ex.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert f"optimal k = {t.k_optimal}" in out and "global accuracy" in out
    assert 0.0 <= res.global_acc <= 1.0


def test_fedrac_sim_setups_match_jax_and_run(monkeypatch, capsys):
    ex = load_example("torch_fedrac_sim")
    for mod in (j_sim_run, t_sim_run):
        monkeypatch.setattr(mod, "run", lambda args, _m=mod: _m.build(args))
    for _, flags in ex.SCENARIOS:
        j, _ = j_sim_run.main([*flags, *ex.COMMON])
        t, _ = t_sim_run.main(ex.scenario_argv(flags, "cpu"))
        assert_same_setup(j, t)
    monkeypatch.undo()
    reports = ex.main(["--device", "cpu"])
    assert len(reports) == len(ex.SCENARIOS) == 4
    assert [r.summary()["rounds"] for r in reports] == [6] * 4
    assert capsys.readouterr().out.count("TOTAL wall-clock") == 4


@pytest.mark.parametrize("name,argv", [
    ("torch_quickstart", []), ("torch_fedrac_sim", []),
    ("torch_fedrac_cnn_full", ["--samples", "600", "--rounds", "1"])])
def test_examples_without_card_raise(monkeypatch, name, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_example(name).main(argv)
