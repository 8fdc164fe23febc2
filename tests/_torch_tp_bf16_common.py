"""Rank side of ``tests/test_torch_tp_bf16.py``: a bf16 LM federation on
a 1x2 gloo world with the tensor-parallel member forward, recording the
dtypes of the leaves its member step sees.  It imports neither JAX nor
the JAX package.
"""
import dataclasses

from _torch_tp_common import CFG, TokenHooks
from _torch_tp_families_common import federation
from repro_torch.configs import get_config
from repro_torch.core import server as t_srv
from repro_torch.core.families import lm_family
from repro_torch.core.resources import participants_from_matrix
from repro_torch.core.tree import tree_leaves
from repro_torch.launch.mesh import make_host_mesh


def bf16_config():
    return get_config("olmo-1b", smoke=True).replace(dtype="bfloat16")


def bf16_rank(rank):
    """The dtypes of every leaf each member step's loss saw, the trained
    models' leaf dtypes, and whether their losses are finite."""
    fam = lm_family(bf16_config(), 0.5)
    seen = set()

    def loss_and_logits(level, params, batch):
        seen.update(str(x.dtype) for x in tree_leaves(params))
        return lm_loss(level, params, batch)

    lm_loss = fam.loss_and_logits
    fam = dataclasses.replace(fam, loss_and_logits=loss_and_logits)
    V, n_data, cd, test = federation()
    cfg = t_srv.FLConfig(**dict(CFG, aggregation="sync",
                                class_balanced=False))
    cls = type("TokenFedRAC", (TokenHooks, t_srv.FedRAC), {})
    eng = cls(participants_from_matrix(V, n_data=n_data), cd, fam, cfg,
              classes=64, device="cpu", mesh=make_host_mesh(1, 2)).setup()
    assert eng._tp
    seen.clear()
    res = eng.train(test)
    trained = sorted({str(x.dtype) for p in eng.cluster_params.values()
                      for x in tree_leaves(p)})
    finite = all(h == h for hist in res.history.values() for h in hist)
    return sorted(seen), trained, finite
