"""The system under test: the program's ``FedRAC`` engine on a
configuration and a federation.

The benchmark's engine subclass adds only the engine's documented hooks
(through the configuration's kind) and the benchmark's spans around
``init_params`` (in the calls that time spans it ends in a synchronize,
so it covers the copy to the card), ``evaluate`` and ``dispatch_rounds``;
it keeps a reference to each dispatch block's per-round member losses,
the block's own output, for ``failed`` and for the check.  With
``--trace 0`` the spans are no-ops.
"""
from __future__ import annotations

import importlib

FL_KEYS = ("compact_to", "rounds", "rounds_per_dispatch", "steps_per_round",
           "local_batch", "lr", "use_kd", "kd_T", "kd_alpha",
           "class_balanced")


def kind_module(cfg: dict):
    return importlib.import_module(f"bench.kinds.{cfg['kind']}")


def build_engine(cfg: dict, traffic: dict, fed: dict, seed: int, device,
                 spans):
    from repro_torch.core import server as srv
    from repro_torch.core.resources import participants_from_matrix
    kind = kind_module(cfg)
    base = kind.engine_base(srv)

    class BenchFedRAC(base):
        def init_params(self, level):
            with spans.span("init_params", fence=spans.fences):
                return super().init_params(level)

        def evaluate(self, level, params, test):
            with spans.span("evaluate"):
                return super().evaluate(level, params, test)

        def dispatch_rounds(self, level, *args, **kw):
            with spans.span("dispatch_rounds"):
                out = super().dispatch_rounds(level, *args, **kw)
            self.block_losses.append((level, out.losses))
            return out

    fl = srv.FLConfig(seed=seed, **{k: traffic["fl"][k] for k in FL_KEYS})
    parts = participants_from_matrix(
        fed["resources"], [len(next(iter(s.values()))) for s in fed["shards"]])
    eng = BenchFedRAC(parts, fed["shards"], kind.family(cfg), fl,
                      classes=kind.classes(cfg), device=device)
    eng.block_losses = []
    return eng.setup()


def layout(eng) -> dict:
    """What decides the work of a ``train()`` call: each cluster's members,
    padded capacity and plane length."""
    return {str(l): {"members": len(m), "capacity": eng._capacity(len(m)),
                     "d_pad": eng.plane_spec(l).d_pad}
            for l, m in sorted(eng.assignment.members.items()) if m}


def flat_params(tree, prefix=""):
    """{path: tensor} of a params pytree (dict keys and list indices joined
    by "/")."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flat_params(v, f"{prefix}/{k}" if prefix else str(k)))
    return out
