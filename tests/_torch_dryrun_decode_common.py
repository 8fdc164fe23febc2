"""Rank-side halves of ``tests/test_torch_dryrun_decode.py``: the compile
analysis's decode programs of every mixer at smoke size, analysed in a
fake world and run for real on a world of gloo ranks.  Like
``_torch_dryrun_common``, this module imports neither JAX nor the JAX
package.
"""
from repro_torch.configs import InputShape, get_config
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import dryrun, hlo_analysis, sharding
from repro_torch.launch.mesh import fake_world, make_host_mesh

MESHES = ("1x2", "2x1")
SEQ = 16
# (name, arch, cache_shard, batch, config overrides): each mixer on each
# cache layout its decode splits; OLMo with 3 query heads, which do not
# divide 2 (q_dim 192 splits, cutting a head); FSDP parameters
PROGRAMS = (
    ("jamba-hd", "jamba-v0.1-52b", "hd", 4, {}),
    ("jamba-batch", "jamba-v0.1-52b", "batch", 4, {}),
    ("jamba-seq", "jamba-v0.1-52b", "seq", 4, {}),
    ("xlstm-hd", "xlstm-350m", "hd", 4, {}),
    ("xlstm-batch", "xlstm-350m", "batch", 4, {}),
    ("seamless-hd", "seamless-m4t-medium", "hd", 4, {}),
    ("seamless-seq", "seamless-m4t-medium", "seq", 4, {}),
    ("olmo-seq", "olmo-1b", "seq", 4, {}),
    ("olmo-seq-b1", "olmo-1b", "seq", 1, {}),
    ("olmo-h3-batch", "olmo-1b", "batch", 4, dict(n_heads=3, n_kv_heads=3)),
    ("olmo-h3-hd", "olmo-1b", "hd", 4, dict(n_heads=3, n_kv_heads=3)),
    # FSDP parameters, gathered per use, against the split caches
    ("olmo-fsdp-hd", "olmo-1b", "hd", 4, dict(shard_mode="fsdp")),
    ("jamba-fsdp-seq", "jamba-v0.1-52b", "seq", 4, dict(shard_mode="fsdp")),
    ("xlstm-fsdp-batch", "xlstm-350m", "batch", 4, dict(shard_mode="fsdp")),
)
# a position in each rank's slice of a sequence split in two, for the
# programs whose cache splits its sequence (the owner writes the new K/V)
SEQ_POSITIONS = (5, 13)


def positions(name):
    cache_shard = dict((p[0], p[2]) for p in PROGRAMS)[name]
    b1 = dict((p[0], p[3]) for p in PROGRAMS)[name] == 1
    return SEQ_POSITIONS if cache_shard == "seq" or b1 else SEQ_POSITIONS[1:]


def lowered(name, mesh, pos):
    """(Lowered, vocabulary of its token) of a decode program."""
    _, arch, cache_shard, batch, over = [p for p in PROGRAMS
                                         if p[0] == name][0]
    cfg = get_config(arch, smoke=True).replace(cache_shard=cache_shard,
                                                **over)
    shape = InputShape(f"d{SEQ}", SEQ, batch, "decode")
    return dryrun.lower_one(cfg, shape, mesh, pos=pos)[0], cfg.vocab_size


def _mesh(shape):
    return make_host_mesh(*(int(s) for s in shape.split("x")))


def fake_records():
    """{(mesh, program, pos): the collective record of rank 0's program
    analysed on fake tensors in a fake world of 2 ranks}."""
    out = {}
    for shape in MESHES:
        with fake_world(2):
            mesh = _mesh(shape)
            for name, *_ in PROGRAMS:
                for pos in positions(name):
                    out[shape, name, pos] = lowered(name, mesh, pos)[
                        0].analyze()["collectives"]
    return out


def real_rank(rank, shape):
    """{(program, pos): (this rank's collective record, the largest
    difference of its logits and cache from its block of the one-device
    decode's)} (the default group is the real world)."""
    mesh = _mesh(shape)
    out = {}
    for name, *_ in PROGRAMS:
        for pos in positions(name):
            low, vocab = lowered(name, mesh, pos)
            args = low.materialize("cpu", seed=0, vocab=vocab)
            with hlo_analysis.record_collectives() as rec:
                got = low.fn(*args)
            one, _ = lowered(name, None, pos)
            want = one.fn(*one.materialize("cpu", seed=0, vocab=vocab))
            out[name, pos] = (list(rec), decode_error(mesh, low, got, want))
    return out


def decode_error(mesh, low, got, want):
    """The largest |got - want block| over the logits (batch as the
    cache's batch splits, vocabulary over the model axis where it
    divides) and every cache leaf (by its spec)."""
    c_specs = dryrun._spec_leaves(low.arg_specs[1])
    vocab = want[0].shape[-1] % sharding._shape(mesh).get("model", 1) == 0
    blocks = [(got[0], want[0], sharding.P(c_specs[0][1], None,
                                           "model" if vocab else None))]
    blocks += zip(tree_leaves(got[1]), tree_leaves(want[1]),
                  c_specs)
    return max(float((g - sharding.local_block(
        mesh, w, sharding.spec_dims(s))).abs().max())
        for g, w, s in blocks)
