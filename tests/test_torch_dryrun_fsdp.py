"""The compile analysis's ``shard_mode="fsdp"`` programs (``launch.dryrun``,
``models.fsdp``) at smoke size on the CPU.

* OLMo's FSDP train, prefill and KD steps, and a train step whose every
  superblock leaf splits its stack dim (so a superblock's slice lives on
  one rank), are analysed on fake tensors in a fake world of 2 ranks, then
  run on real tensors by 2 gloo ranks, on the meshes 1x2 and 2x1: every
  rank's collective record (all-gathers per use, reduce-scatters of the
  gradients) equals the fake rank's, call for call; every rank's updated
  parameters and optimizer state (its slices), its CE, and prefill's
  logits equal its block of the one-device program's at rtol 2e-4 /
  atol 1e-5.
* The fake trace's memory: under ``remat`` the superblock's leaves are
  gathered inside its recomputation, so the temporaries grow from depth 2
  to 3 by less than one superblock's gathered bytes; without it every
  superblock's gathered leaves stay saved for the backward, and they grow
  by more.  (From depth 1 to 2 the gradient of the two-superblock stack
  adds its own share.)
"""
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import pytest

from _torch_dryrun_fsdp_common import MESHES, PROGRAMS, TRAIN, \
    fake_records, real_rank
from _torch_mesh_common import start_world
from _torch_threads import one_torch_thread  # noqa: F401

from repro_torch.configs import get_config
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import fake_world, make_host_mesh


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


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("program", PROGRAMS)
def test_fsdp_step_equals_the_one_device_step(records, shape, program):
    fake, real = records
    want = fake[shape, program]
    kinds = {fn for fn, _, _ in want}
    assert "sharding.all_gather" in kinds
    assert ("sharding.reduce_scatter" in kinds) == (program != "prefill")
    for rank in real[shape]:
        record, share = rank[program]
        assert record == want
        assert share <= 1.0


@pytest.mark.parametrize("remat", [True, False])
def test_gathered_leaves_do_not_outlive_their_superblock(remat):
    temps = {}
    with fake_world(2):
        mesh = make_host_mesh(1, 2)
        for depth in (2, 3):
            cfg = get_config("olmo-1b", smoke=True).replace(
                shard_mode="fsdp", n_layers=depth, remat=remat)
            temps[depth] = dryrun.lower_one(cfg, TRAIN, mesh)[0].analyze()[
                "memory"]["temp_size_in_bytes"]
    one = specs.params_shape(get_config("olmo-1b", smoke=True).replace(
        n_layers=1))
    gathered = sum(x.numel() * x.element_size()
                   for x in tree_leaves(one["blocks"]))
    grows = temps[3] - temps[2]
    assert (grows < gathered) == remat
