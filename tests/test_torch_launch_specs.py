"""The compile analysis's shapes and sharding rules against the JAX
package's, for all ten ``ARCHS`` at full width and the four
``INPUT_SHAPES``, on both production meshes.

* ``launch.specs``: ``params_shape``, ``train_inputs`` and
  ``decode_inputs`` (its cache through ``init_cache`` on fake tensors)
  have the leaf shapes and dtypes of JAX's ``eval_shape`` structs, and
  ``applicable`` agrees.
* ``launch.sharding``: ``param_specs`` ("tp" and "fsdp"), ``batch_specs``
  (both modes), ``cache_specs`` (``cache_shard`` "hd" / "seq" / "batch",
  with and without ``shard_seq``) and ``dryrun.prefill_out_spec`` equal
  JAX's.  JAX's side is built on an ``AbstractMesh`` as
  ``tests/test_sharding_rules.py`` does; the port's takes the mesh's
  ``{axis: size}``, which is all the rules read.  Specs are compared
  normalised (each entry a tuple of axis names), since JAX 0.9.0 writes
  ``'data'`` where an older JAX kept ``('data',)``.
* ``to_named`` places each ``Spec`` as DTensor placements in mesh order.

No tolerance: shapes, dtypes and specs are equal or not.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as JP

from _torch_threads import one_torch_thread  # noqa: F401

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.launch import sharding as j_sharding
from repro.launch import specs as j_specs
from repro.launch.dryrun import prefill_out_spec as j_prefill_out_spec

from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.launch import sharding, specs
from repro_torch.launch.dryrun import prefill_out_spec

jax.config.update("jax_platform_name", "cpu")

MESHES = {"16x16": (("data", 16), ("model", 16)),
          "2x16x16": (("pod", 2), ("data", 16), ("model", 16))}


def _abstract_mesh(axes):
    try:                                  # jax <= 0.5: shape_tuple pairs
        return AbstractMesh(tuple(axes))
    except TypeError:                     # newer jax: (sizes, names)
        return AbstractMesh(tuple(s for _, s in axes),
                            tuple(n for n, _ in axes))


def _norm(spec, nd=None):
    """A spec (JAX's PartitionSpec or the port's Spec) as a tuple of
    tuples of axis names, one per dim."""
    out = [() if e is None else (e,) if isinstance(e, str) else tuple(e)
           for e in spec]
    if nd is not None:
        out += [()] * (nd - len(out))
    return tuple(out)


def _jax_leaves(tree, is_leaf=None):
    """(path, leaf) in sorted-key order, the path as key names."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p), x)
            for p, x in flat]


def _port_leaves(tree, path=()):
    if isinstance(tree, sharding.Spec) or torch.is_tensor(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _port_leaves(tree[k], path + (k,))]
    return [x for i, v in enumerate(tree)
            for x in _port_leaves(v, path + (i,))]


def _same_structs(port, jax_tree):
    got = [(p, tuple(x.shape), str(x.dtype).removeprefix("torch."))
           for p, x in _port_leaves(port)]
    want = [(p, tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in _jax_leaves(jax_tree)]
    assert got == want


def _same_specs(port, jax_tree, shapes):
    """Specs equal leaf by leaf; ``shapes`` (the port's leaves) give each
    spec its rank, since a PartitionSpec may be shorter than its leaf."""
    nds = {p: x.dim() for p, x in _port_leaves(shapes)}
    got = [(p, _norm(s, nds[p])) for p, s in _port_leaves(port)]
    want = [(p, _norm(s, nds[p])) for p, s in
            _jax_leaves(jax_tree, is_leaf=lambda x: isinstance(x, JP))]
    assert got == want


@functools.lru_cache(maxsize=None)
def _params(arch, **over):
    cfg = get_config(arch).replace(**over)
    jcfg = j_get_config(arch).replace(**over)
    return cfg, jcfg, specs.params_shape(cfg), j_specs.params_shape(jcfg)


CASES = [(a, s) for a in list_archs() for s in INPUT_SHAPES]


@pytest.mark.parametrize("arch", list_archs())
def test_params_shape_and_param_specs_equal_jax(arch):
    cfg, jcfg, p, jp = _params(arch)
    _same_structs(p, jp)
    for name, axes in MESHES.items():
        mesh, jmesh = dict(axes), _abstract_mesh(axes)
        for mode in ("tp", "fsdp"):
            c, jc = cfg.replace(shard_mode=mode), jcfg.replace(shard_mode=mode)
            _same_specs(sharding.param_specs(c, p, mesh),
                        j_sharding.param_specs(jc, jp, jmesh), p)
        if cfg.n_experts:
            c, jc = cfg.replace(moe_shard="ep"), jcfg.replace(moe_shard="ep")
            _same_specs(sharding.param_specs(c, p, mesh),
                        j_sharding.param_specs(jc, jp, jmesh), p)


@pytest.mark.parametrize("arch,shape", CASES)
def test_inputs_and_their_specs_equal_jax(arch, shape):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    ishape, jshape = INPUT_SHAPES[shape], J_SHAPES[shape]
    assert specs.applicable(cfg, shape) == j_specs.applicable(jcfg, shape)
    if ishape.kind in ("train", "prefill"):
        batch, jbatch = (specs.train_inputs(cfg, ishape),
                         j_specs.train_inputs(jcfg, jshape))
        _same_structs(batch, jbatch)
        for axes in MESHES.values():
            mesh, jmesh = dict(axes), _abstract_mesh(axes)
            for mode in ("tp", "fsdp"):
                c, jc = (cfg.replace(shard_mode=mode),
                         jcfg.replace(shard_mode=mode))
                _same_specs(sharding.batch_specs(c, batch, mesh),
                            j_sharding.batch_specs(jc, jbatch, jmesh), batch)
            dp = tuple(a for a in mesh if a in ("pod", "data"))
            assert (_norm(prefill_out_spec(cfg, ishape, mesh, dp))
                    == _norm(j_prefill_out_spec(jcfg, jshape, jmesh, dp)))
        return
    token, pos, cache = specs.decode_inputs(cfg, ishape)
    jtoken, jpos, jcache = j_specs.decode_inputs(jcfg, jshape)
    _same_structs((token, pos, cache), (jtoken, jpos, jcache))
    for axes in MESHES.values():
        mesh, jmesh = dict(axes), _abstract_mesh(axes)
        for shard in ("hd", "seq", "batch"):
            c, jc = (cfg.replace(cache_shard=shard),
                     jcfg.replace(cache_shard=shard))
            for shard_seq in (False, True):
                _same_specs(
                    sharding.cache_specs(c, cache, mesh, shard_seq=shard_seq),
                    j_sharding.cache_specs(jc, jcache, jmesh,
                                           shard_seq=shard_seq), cache)


def test_to_named_places_specs_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = dict(MESHES["2x16x16"])
    P = sharding.P
    got = sharding.to_named(mesh, {"a": P(("data", "model"), None),
                                   "b": P(None, "model"),
                                   "c": [P(("pod", "data"), None, None)],
                                   "d": P()})
    assert got == {"a": (Replicate(), Shard(0), Shard(0)),
                   "b": (Replicate(), Replicate(), Shard(1)),
                   "c": [(Shard(0), Shard(0), Replicate())],
                   "d": (Replicate(),) * 3}
    assert sharding.spec_dims(P(("data", "model"), "pod")) == {
        "data": 0, "model": 0, "pod": 1}
    assert sharding.local_shape((512, 6), P(("data", "model"), None),
                                mesh) == (2, 6)
