"""Rank-side halves of ``tests/test_torch_dryrun_fsdp.py``: the compile
analysis's ``shard_mode="fsdp"`` programs at smoke size, analysed in a
fake world and run for real on a world of gloo ranks.  Like
``_torch_dryrun_common``, this module imports neither JAX nor the JAX
package.
"""
from repro_torch.configs import InputShape, get_config
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import dryrun, hlo_analysis, sharding
from repro_torch.launch.mesh import fake_world, make_host_mesh
from repro_torch.launch.sharding import P

MESHES = ("1x2", "2x1")
TRAIN = InputShape("t16", 16, 4, "train")
PREFILL = InputShape("p16", 16, 4, "prefill")
PROGRAMS = ("train", "prefill", "kd", "train-stack")


def _cfg(program):
    cfg = get_config("olmo-1b", smoke=True).replace(shard_mode="fsdp")
    # four superblocks: the stack dim (4) divides the two ranks
    return cfg.replace(n_layers=4) if program == "train-stack" else cfg


def stack_specs(p_spec):
    """FSDP specs whose every superblock leaf splits its stack dim."""
    def spec(path, s):
        if path[0] != "blocks":
            return s
        return P(("data", "model"), *([None] * (len(s) - 1)))
    return sharding.map_specs(spec, p_spec)


def lowered(program, mesh):
    """(Lowered, vocabulary of its tokens) of an FSDP program (the whole
    program on one device when ``mesh`` is None)."""
    cfg = _cfg(program)
    if program == "kd":
        return dryrun.lower_one(cfg, TRAIN, mesh, kd=True)[0], cfg.vocab_size
    if program == "prefill":
        return dryrun.lower_one(cfg, PREFILL, mesh)[0], cfg.vocab_size
    low = dryrun.lower_one(cfg, TRAIN, mesh)[0]
    if program == "train-stack" and mesh is not None:
        p_spec = stack_specs(low.arg_specs[0])
        b_spec = low.arg_specs[2]
        axes = tuple(a for a in dryrun._lead_axes(b_spec["tokens"])
                     if dryrun.axis_size(mesh, a) > 1)
        step, _ = dryrun.make_train_step(cfg, mesh=mesh, p_spec=p_spec,
                                         batch_axes=axes)
        low = dryrun.Lowered(step, low.args,
                             (p_spec, {"m": p_spec, "v": p_spec, "t": P()},
                              b_spec), mesh, opt_args=(1,))
    return low, cfg.vocab_size


def _mesh(shape):
    return make_host_mesh(*(int(s) for s in shape.split("x")))


def fake_records():
    """{(mesh, program): rank 0's collective record on fake tensors in a
    fake world of 2 ranks}."""
    out = {}
    for shape in MESHES:
        with fake_world(2):
            mesh = _mesh(shape)
            for program in PROGRAMS:
                out[shape, program] = lowered(program, mesh)[0].analyze()[
                    "collectives"]
    return out


def real_rank(rank, shape):
    """{program: (this rank's collective record, the largest relative
    difference of its outputs from its block of the one-device
    program's)}."""
    mesh = _mesh(shape)
    out = {}
    for program in PROGRAMS:
        low, vocab = lowered(program, mesh)
        args = low.materialize("cpu", seed=0, vocab=vocab)
        with hlo_analysis.record_collectives() as rec:
            got = low.fn(*args)
        one, _ = lowered(program, None)
        want = one.fn(*one.materialize("cpu", seed=0, vocab=vocab))
        out[program] = (list(rec), output_error(mesh, low, program, got,
                                                want))
    return out


def output_error(mesh, low, program, got, want, rtol=2e-4, atol=1e-5):
    """The largest |got - want block| / (atol + rtol |want block|) over
    the outputs: the updated parameters and optimizer state (by their
    specs) and the loss; prefill's last-position logits (batch as the
    tokens split)."""
    if program == "prefill":
        lead = low.arg_specs[1]["tokens"][0]
        pairs = [(got, want, P(lead, None))]
    else:
        p_spec, o_spec = low.arg_specs[-3], low.arg_specs[-2]
        pairs = list(zip(tree_leaves(got[0]), tree_leaves(want[0]),
                         dryrun._spec_leaves(p_spec)))
        pairs += zip(tree_leaves(got[1]), tree_leaves(want[1]),
                     dryrun._spec_leaves(o_spec))
        pairs.append((got[2], want[2], P()))
    worst = 0.0
    for g, w, s in pairs:
        w = sharding.local_block(mesh, w, sharding.spec_dims(s))
        d = (g.double() - w.double()).abs() / (atol + rtol * w.double().abs())
        worst = max(worst, float(d.max()))
    return worst
