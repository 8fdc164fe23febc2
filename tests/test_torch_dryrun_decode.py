"""The compile analysis's decode of every mixer on a model axis, and
sequence-sharded decode (``launch.dryrun``, ``models.attention``'s
``seq_shard_ctx``), at smoke size on the CPU.

Each program of ``_torch_dryrun_decode_common.PROGRAMS`` (jamba's Mamba
and attention on the "hd", "batch" and "seq" caches; the xLSTM's mLSTM
and sLSTM on "hd" and "batch"; seamless's self- and cross-attention on
"hd" and "seq"; OLMo on "seq" at batch 4 and at batch 1, whose sequence
splits over the data axes too; OLMo with 3 query heads, which do not
divide 2; and FSDP parameters, gathered per use and cut to their
tensor-parallel blocks, on OLMo's "hd", jamba's "seq" and the xLSTM's
"batch" caches) is analysed on fake tensors in a fake world of 2 ranks,
then run on real tensors by 2 gloo ranks, on the meshes 1x2 and 2x1:

* every rank's collective record (function, axis, bytes) equals the fake
  rank's, call for call;
* every rank's logits and cache leaves equal its block of the one-device
  decode's, fp32 at atol 1e-5 (the split decode sums the same products in
  another order);
* where the sequence splits, the decode runs at a position in each
  rank's slice in turn, so each rank is once the one that writes the new
  K/V.

The one-device ``registry.decode_step`` of each of these archs is held to
JAX's ``repro.models.registry.decode_step`` per step by
``tests/test_torch_decode.py`` (all ten archs, rtol 2e-4 / atol 1e-5); the
OLMo variant with 3 heads runs the same one-device code.
"""
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import pytest

from _torch_dryrun_decode_common import MESHES, PROGRAMS, fake_records, \
    positions, real_rank
from _torch_mesh_common import start_world
from _torch_threads import one_torch_thread  # noqa: F401

# programs that start no collective: on 2x1 the model axis is one rank
# and only a batch of 1 splits its sequence over the data axis (FSDP
# parameters are gathered over it)
SILENT = {("2x1", p[0]) for p in PROGRAMS
          if p[3] > 1 and p[4].get("shard_mode") != "fsdp"}

CASES = [(shape, name, pos) for shape in MESHES for name, *_ in PROGRAMS
         for pos in positions(name)]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """(fake records, {mesh: [each rank's real records]})."""
    with ProcessPoolExecutor(1, mp_context=get_context("spawn")) as pool:
        fake = pool.submit(fake_records)
        real = {}
        for shape in MESHES:
            real[shape] = start_world(real_rank,
                                      tmp_path_factory.mktemp(shape), shape,
                                      world=2)()
        return fake.result(), real


@pytest.mark.parametrize("shape,name,pos", CASES)
def test_split_decode_equals_the_one_device_block(records, shape, name, pos):
    fake, real = records
    want = fake[shape, name, pos]
    assert bool(want) != ((shape, name) in SILENT)
    for rank in real[shape]:
        record, err = rank[name, pos]
        assert record == want
        assert err < 1e-5
