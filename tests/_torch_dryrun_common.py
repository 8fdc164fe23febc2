"""Rank-side halves of ``tests/test_torch_dryrun.py`` (and the xLSTM
traces of ``test_torch_dryrun_xlstm.py``): the compile
analysis's programs at smoke size, analysed in a fake world and run for
real on a world of gloo ranks.  Like ``_torch_mesh_common``, whose spawn
it uses, this module imports neither JAX nor the JAX package.
"""
from repro_torch.configs import InputShape, get_config
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.mesh import fake_world, make_host_mesh

MESHES = ("1x2", "2x1")
TRAIN = InputShape("t16", 16, 4, "train")
PREFILL = InputShape("p16", 16, 4, "prefill")
DECODE = InputShape("d16", 16, 4, "decode")
FL = dict(clients=4, local_batch=2, seq=16, steps=1)
# (name, arch, program): every kind of program on a dense and an MoE arch
# (decode on both cache layouts the port splits: "hd" and "batch")
PROGRAMS = (("olmo-train", "olmo-1b", "train"),
            ("olmo-prefill", "olmo-1b", "prefill"),
            ("olmo-kd", "olmo-1b", "kd"),
            ("olmo-decode-hd", "olmo-1b", "decode-hd"),
            ("granite-train", "granite-moe-1b-a400m", "train"),
            ("granite-decode-batch", "granite-moe-1b-a400m", "decode-batch"),
            ("granite-fl", "granite-moe-1b-a400m", "fl"))


def lowered(arch, program, mesh):
    """(Lowered, vocabulary of its token inputs) of a program."""
    cfg = get_config(arch, smoke=True)
    if program == "fl":
        low, fcfg = dryrun.lower_fl_round(cfg, mesh, **FL)
        return low, fcfg.vocab_size
    if program == "kd":
        return dryrun.lower_one(cfg, TRAIN, mesh, kd=True)[0], cfg.vocab_size
    if program.startswith("decode"):
        cfg = cfg.replace(cache_shard=program.split("-")[1])
        return dryrun.lower_one(cfg, DECODE, mesh)[0], cfg.vocab_size
    shape = TRAIN if program == "train" else PREFILL
    return dryrun.lower_one(cfg, shape, mesh)[0], cfg.vocab_size


def _mesh(shape):
    return make_host_mesh(*(int(s) for s in shape.split("x")))


def fake_records():
    """{(mesh, program name): the collective record of rank 0's program
    analysed on fake tensors in a fake world of 2 ranks}."""
    out = {}
    for shape in MESHES:
        with fake_world(2):
            mesh = _mesh(shape)
            for name, arch, program in PROGRAMS:
                out[shape, name] = lowered(arch, program, mesh)[0].analyze()[
                    "collectives"]
    return out


def real_rank(rank, shape):
    """{program name: (this rank's collective record, and for a decode
    program the largest difference of its logits and caches from this
    rank's block of the one-device program's)} of each program run on
    real tensors (the default group is the real world)."""
    mesh = _mesh(shape)
    out = {}
    for name, arch, program in PROGRAMS:
        low, vocab = lowered(arch, program, mesh)
        args = low.materialize("cpu", seed=0, vocab=vocab)
        with hlo_analysis.record_collectives() as rec:
            got = low.fn(*args)
        err = None
        if program.startswith("decode"):
            one, _ = lowered(arch, program, None)
            want = one.fn(*one.materialize("cpu", seed=0, vocab=vocab))
            err = _decode_error(mesh, low, got, want)
        out[name] = (list(rec), err)
    return out


def _decode_error(mesh, low, got, want):
    """The largest |got - want block| over the logits (batch over the
    data axis, vocabulary over the model axis) and the cache (by its
    specs)."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import sharding
    blocks = [(got[0], want[0], sharding.P("data", None, "model"))]
    blocks += zip(tree_leaves(got[1]), tree_leaves(want[1]),
                  dryrun._spec_leaves(low.arg_specs[1]))
    return max(float((g - sharding.local_block(
        mesh, w, sharding.spec_dims(s))).abs().max())
        for g, w, s in blocks)


def xlstm_measure(kind, lengths, extrapolate):
    """``dryrun._measure`` of xlstm-350m's smoke config at
    ``lengths[2]`` tokens in a fake world of 2 (mesh 1x2): extrapolated
    from ``lengths[:2]`` or traced directly.  (flops, bytes, collective
    bytes, collective counts, memory, ``seq_extrapolated``)."""
    import torch
    torch.set_num_threads(1)
    cfg = get_config("xlstm-350m", smoke=True)
    shape = InputShape("x", lengths[2], 4, kind)
    with fake_world(2):
        f, b, c, coll, a = dryrun._measure(
            cfg, shape, _mesh("1x2"),
            seq=lengths[:2] if extrapolate else None)
    return f, b, c, coll["counts"], a["memory"], a.get("seq_extrapolated")
