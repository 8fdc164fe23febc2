#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

  python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device   the card, and TF32 turned off for convolutions and matmuls;
  2. build    the three CUDA kernels (fedagg, distill, flash) compiled from
              ``src/repro_torch/kernels``, one nvcc each, all at once;
  3. kernels  each kernel against its plain PyTorch version on the card at
              the shapes the three main paths give it (and a few more), then
              timed with CUDA events: kernel, plain version, the bound from
              bytes and operations, and a library call where one computes
              the same function.  Flash cases name the kernel they took
              (tensor cores: split-TF32 ``mma.sync`` for fp32, ``wgmma``
              for bf16; CUDA cores for hd 8-32), distill cases their split
              count, and two distill calls must give the same bits;
  4. main     Algorithm 1 at the paper's full CNN width (C128-C64-C128-C256-
              C512-D10) on synth-mnist with the 40 Table-III participants,
              four rounds per cluster in one dispatch block, then each slave's
              distillation loss against the master on the test set through
              the kernel route.  Launch counts are set to 0 just before and
              read just after: fedagg must run once per dispatched round of
              every non-empty cluster, distill once per trained slave;
  4b. profile the same training again, warm, on the host clock and under
              torch.profiler: device time by kernel and the busy share;
  4c. sim_main the heterogeneity simulator (``repro_torch.sim``) on the
              same federation at full width under a seeded "mixed" trace:
              8 rounds, MAR policy "buffer", dispatch blocks of up to 4
              rounds; run twice, cold and warm.  fedagg must launch the
              count the records imply (``expected_fedagg_launches``), and
              each kernel shape of the run is held against its plain version;
  4d. sim_legacy the same simulation on the one-round path (R = 1): every
              record's host fields equal sim_main's, no fedagg launch;
  5. cli      ``repro_torch.launch.fl_train`` on the card;
  6. parity   a small CNN federation on the card (deterministic cuDNN) and on
              the CPU from the same initial weights; the final planes must
              agree;
  6b. sim_parity small simulations ("buffer" at R = 2, "mask" at R = 1) on
              the card and on the CPU: equal host fields, losses and final
              planes within the parity tolerance, accuracies within one
              test sample;
  6c. sim_cli ``repro_torch.launch.sim_run`` in a subprocess with every
              observability output, checked by ``repro_torch.obs.validate``;
  6d. async_main the continuous-time async server on sim_main's
              configuration, deterministic cuDNN: (a) ``max_staleness=0``
              against the sync buffered run — final planes, per-round
              losses, accuracies and every record's host fields bit-equal
              (``t_start`` is the earliest cluster clock, not the barrier's);
              (b) unbounded staleness, cold and warm: merges, version lags,
              the staleness histogram, the async wall clock, conservation
              checked on every record a merge files, and fedagg launches
              held to the records' count; fedagg held against its plain
              version at every (C, D) these runs gave it;
  6e. resume  in process, the sync and the unbounded async run without
              checkpoints and with one at every boundary: the same bits,
              and the cost of the writes; then ``repro_torch.launch.sim_run``
              in subprocesses at that configuration (deterministic cuDNN,
              ``sim_cli_child``): a sync dispatch run killed by a real
              SIGKILL inside a block, then resumed; an async run killed at
              a merge event, its newest checkpoint garbage-corrupted, then
              resumed from the one before.  Each resumed report (params
              CRC32 included) equals its uninterrupted control's under
              ``compare_reports``; each control launched fedagg as often as
              its records imply, and fedagg is held against its plain
              version at every (C, D) the processes gave it;
  7. lm_main  Algorithm 1 on the LM family at full OLMo-1B width (two of its
              16 layers), token-only data, attention on the flash kernel:
              master FedAvg and a slave under KD through the dispatch path,
              then the distill kernel on the slave's and the master's
              last-position logits.  Counts set to 0 before and read after:
              fedagg once per dispatched round, flash once per layer for
              every member step (all members in one launch), teacher
              forward and evaluation, and for the report's forwards;
  7b. lm_profile each level's init and plane build on the host clock, then
              the same LM training warm, on the host clock and traced;
  8. lm_parity a small LM (MHA and GQA) on the card and on the CPU from the
              same initial weights; the final planes must agree;
  9. table2   the paper's Table II: Dunn indices at k = 2..6 on Table III
              under λ = (0.4, 0.4, 0.2) for single-restart k-means (its
              Lloyd loop on the card), DBSCAN and OPTICS (host numpy); DI
              values, labels and best k equal to the CPU run's;
  10. fleet   ``FleetSim`` at 10⁶ participants (``sample_profiles``, a
              "mixed" ``FleetTrace``, 8 rounds, "buffer", FedCS), sync and
              async: setup (``fleet_optimal_clusters``) and rounds timed
              apart, every slot conserved in every round, async wall clock
              at most sync's, no kernel launch; then at 10⁵ a run killed at
              round boundary 5 and resumed from its checkpoint gives the
              uninterrupted run's rows bit for bit;
  11. paper   the main path of ``examples/torch_fedrac_cnn_full.py`` with
              its rounds cut from 12 to 4: Fed-RAC, then FedAvg, FedProx,
              Oort and HeteroFL, each round timed; launch counts as the
              example's one-round path implies (none); every returned
              parameter finite and on the card;
  12. baselines_parity the four baselines at a small width on the card and
              on the CPU from the same weights: final parameters within
              the parity tolerance, Oort's choices equal;
  13. examples ``examples/torch_quickstart.py`` and
              ``examples/torch_fedrac_sim.py`` as processes on the card;
  14. moe_main Algorithm 1 on the MoE family at full granite-moe-1b-a400m
              width (two of its 24 layers; 32 experts top-8, GShard capacity
              dispatch; GQA attention on the flash kernel) with lm_main's
              federation and schedule, cold and warm: launch counts as
              lm_main's formula implies, the KD report through the distill
              kernel, the router's aux loss, the share of routing choices
              the capacity keeps; the kernels were checked at this path's
              shapes in phase 3;
  14b. grouped_gemm the grouped GEMM kernels (rows, transposed rows, weight
              gradients) at the benchmark cell granite_moe.fl14_kd's shapes
              (each level's members, experts and width; skewed offsets with
              empty groups and one group of a member's every row) against
              ``ref.py`` in fp64, timed beside the per-group plain version
              and the bound; then the cell's main path (``bench/``'s
              configuration, traffic and engine: 4 of 24 layers, dropless
              routing), one cold ``train()`` with a fresh registry current:
              ``moe/grouped_gemm_launches`` and ``moe/routed_rows`` as the
              code implies;
  15. moe_parity a small MoE federation whose capacity dispatch drops
              tokens, on the card and on the CPU from the same weights: the
              final planes must agree;
  16. families every new mixer at full width in bf16, weights drawn on the
              card: granite-moe (24 layers), jamba's first superblock (8 of
              32 layers: Mamba, attention, MoE), xlstm-350m (24) and
              seamless-m4t-medium (12 + 12): the prefill forward of 2 x 128
              tokens against the same tokens decoded one step at a time,
              per position, within 2**16 times the fp32 CPU gap at smoke
              size, except positions at or after a flip of an MoE router's
              top-k between the two paths; the xLSTM, whose own prefill
              moves by ~1e-3 under a one-ulp nudge, is held in fp32 against
              16 times that response; no kernel launch;
  17. serve   ``repro_torch.launch.serve`` on granite at full width and
              depth in bf16 (batch 4, 32 + 32 tokens), then ``--watch-ckpt``
              on a directory of one valid level-1 plane, a newer corrupt
              step and a newest of another shape: one reload, two steps
              skipped, the reloaded leaves bf16 and equal to the plane's
              model; no kernel launch; then ``examples/torch_serve_demo.py``
              as a process;
  18. train   ``repro_torch.launch.train`` at full OLMo-1B width and depth
              (16 layers, 1.18 G parameters, bf16 with fp32 AdamW moments,
              WSD, batch 8 x 128, 20 steps) as a process: tokens per
              second, the median step, peak memory, the first and last ce,
              the checkpoint's bytes and seconds, its restored bf16 leaves
              equal to the trained ones; then in process one step at 2048
              tokens (OLMo-1B's context) from the same weights with remat
              off and on: loss and gradients within one bf16 rounding,
              both peaks; no kernel launch;
  19. lm_example ``examples/torch_fedrac_lm_train.py`` as a process at
              its defaults: it exits 0 with its assert (the loss fell)
              held (it runs beside phase 13's two processes);
  20. mesh    which backend carries CUDA tensors between two ranks on the
              card (gloo, nccl); then ``repro_torch.launch.sim_run`` on
              sim_main's configuration in process, and with
              ``--mesh-shape`` over ranks started as processes (as
              torch.distributed.run starts them): two ranks on the 1D mesh
              where a backend allows them (else one), and ``2x2
              --no-tp-forward`` where its all_gather works too.  Every
              record's host fields equal the unsharded run's, losses and
              each rank's final planes within the parity tolerance, each
              rank's fedagg launches equal to its records' count, and
              fedagg held against its plain version at every per-rank
              (C/n, D/m) shape.  Beside them run the worlds phase 21
              reads: 1x2 and 2x2 with the tensor-parallel forward;
  21. tp      the tensor-parallel member forward: (a) those CNN worlds
              held as the mesh phase holds its own, and besides, each
              rank's TP planes' whole-leaf copies equal across chunks, no
              plane column gathered along ``model`` inside a block beyond
              the block's outputs, fedagg on (C/n, d_loc) blocks; (b)
              lm_main's federation on a 1x2 mesh of two rank processes
              over gloo, flash on 8 local heads per rank, launches as the
              code implies, the member losses against lm_main's within the
              parity tolerance or 16 times a one-ulp nudge's move (the
              nudged lm_main runs in process first); fedagg at the ranks'
              shapes and flash at the local-head shape held against their
              plain versions, flash timed; (c) the LM's gather path
              (``tp_forward=False``) beside the TP forward on 1x2 at 7 of
              lm_main's 14 participants (two gather ranks at full count
              would each hold lm_main's 46.7 GB), each world's member
              losses against the unsharded run at that count within the
              parity tolerance; per-rank peak memory, seconds and
              collective bytes per round for TP and for the gather path;
  22. tp_families the tensor-parallel forward of the other families, each
              world two rank processes over gloo: (a) moe_main's
              federation (granite-moe at full width, 2 of 24 layers,
              capacity dispatch, flash) on 1x2, held as (b) of phase 21
              holds lm_main's (member losses against moe_main's records
              within the parity tolerance or 16 times a one-ulp nudge's
              move, launches as the code implies, whole-leaf copies
              equal), each rank's peak below moe_main's, and the routers'
              top-k on the master's first batch under TP equal to the
              unsharded forward's but at near-ties; (b) xlstm-350m at
              full width (6 of 24 layers, chunkwise mLSTM) on the same
              federation, unsharded here, then on 1x2, held alike; (c)
              jamba's Mamba mixer and MoE FFN, and xlstm-350m's mLSTM
              and sLSTM blocks, at full width at module level on 1x2:
              forward and per-member gradients under ``vmap(grad)``
              against the unsharded module within the parity tolerance
              (the mLSTM block's forward on every seed within its own
              unsharded card-against-host share, C10); (d) in
              that world, OLMo-1B (2 of 16 layers) from a bf16 template:
              the TP member step sees and trains bf16 leaves, its
              gradients near the unsharded bf16 step's (C8).
              fedagg at the granite ranks' blocks and flash at their
              local-head GQA shape held against their plain versions and
              timed, fedagg at the xLSTM ranks' blocks held too.  Per
              world: peak memory a rank, seconds, collective bytes by
              kind;
  23. dryrun  the compile analysis (``repro_torch.launch.dryrun``): the
              training step of OLMo-1B at full width and depth, bf16,
              8 x 128, on the card, and granite-moe's FL round on a 2x1
              world of two gloo ranks, each analysed first on fake
              tensors in a fake world; the collective record and the
              FLOPs counted on the card equal the fake ones, and the
              card's peak lies within DRYRUN_BAND of the predicted one;
              then a 1x2 world of two gloo ranks (``dryrun_world_child``)
              runs, held alike, five more programs: OLMo-1B's decode on
              the "seq" cache, xlstm-350m's and seamless-m4t-medium's on
              the "hd" cache, jamba's Mamba mixer's decode step, and
              OLMo-1B's training step under FSDP; each rank's outputs
              against its block of the one-device program's.
The kernels phase also checks fedagg's JAX-named wrappers
(``aggregate_plane``, ``aggregate_tree``) at widths that are not
multiples of 4.  Then the kernels line, the card's name and power limit as nvidia-smi gives
them, and last ``{"ok": true, "device": {...}}``.  Any failure raises, so
the script exits nonzero and prints no last line.  It exits nonzero at once
when no CUDA card is visible or the package is not beside it.
"""
from __future__ import annotations

import contextlib
import functools
import io
import json
import logging
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
FP32_FLOPS_PER_S = 67e12           # H100 SXM fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 on the tensor cores
# fp32 on the tensor cores by split TF32: three TF32 products (495 TFLOP/s
# dense) for each fp32 one
TF32X3_FLOPS_PER_S = 495e12 / 3
PEAK_NAMES = {FP32_FLOPS_PER_S: "fp32 CUDA-core 67 TFLOP/s",
              BF16_FLOPS_PER_S: "bf16 tensor 989 TFLOP/s",
              TF32X3_FLOPS_PER_S: "split-TF32 tensor 495/3 = 165 TFLOP/s"}
L2_BYTES = 50 * 2 ** 20
ITERS, ITERS_LARGE = 50, 20        # timed calls per measurement
# fp32 operations the distill kernels do per (student, teacher) logit pair:
# split vocabulary (V > 1024) 2 multiplies by 1/T, 2 max, 3 exp, 3
# subtracts, 3 adds, 2 multiply-adds, 1 compare; one warp per row (V <= 1024)
# 2 divides, 3 max, 6 exp, 4 subtracts, 9 multiply-adds, 1 compare
DISTILL_OPS_PER_LOGIT = {"split": 16, "warp-per-row": 25}
FEDAGG_RTOL, FEDAGG_ATOL = 1e-5, 1e-6
# tests/test_kernels_flash.py: fp32 and bf16 tolerances of the flash kernel
FLASH_TOL = {"float32": (1e-4, 2e-5), "bfloat16": (3e-2, 3e-2)}
PARITY_RTOL, PARITY_ATOL = 2e-4, 1e-5
# the LM card-vs-CPU check: the same fp32 tolerance as the CNN's
LM_PARITY_RTOL, LM_PARITY_ATOL = 2e-4, 1e-5
LM_PARTICIPANTS, LM_CORPUS_TOKENS, LM_SEQ = 14, 12_000, 256
# the MoE main path (lm_main's federation and schedule)
MOE_ARCH = "granite-moe-1b-a400m"
# the MoE card-vs-CPU check: lm_parity's federation on a small GQA MoE LM
# whose capacity dispatch drops tokens (groups of one 17-token window at
# capacity factor 0.5: 34 routing choices for 8 experts of 4 slots)
MOE_SMALL = dict(name="matrix-moe", family="moe", n_layers=2, d_model=32,
                 n_heads=4, n_kv_heads=2, head_dim=8, d_ff=16, vocab_size=64,
                 ffn_pattern=("moe",), n_experts=8, experts_per_tok=2,
                 moe_impl="capacity", moe_group=17, moe_capacity=0.5,
                 rope_theta=1e4, attn_impl="pallas")
# every new mixer at full width in bf16: the configuration's depth cut, and
# the precision at which prefill == decode is held.  At full width the
# xLSTM's own prefill moves by about 1e-3 of its largest logit under a
# one-ulp fp32 nudge of its embeddings (this phase's fp32 record), so bf16
# rounding alone parts its decode from its prefill by tens of per cent: it
# is held in fp32, against that response
FAMILIES = (("granite-moe-1b-a400m", {}, "bf16"),
            ("jamba-v0.1-52b", {"n_layers": 8}, "bf16"),
            ("xlstm-350m", {}, "fp32"),
            ("seamless-m4t-medium", {}, "bf16"))
FAMILY_B, FAMILY_S, SMOKE_S = 2, 128, 32
# bf16 keeps 8 significant bits to fp32's 24: the bf16 tolerance of the
# prefill-vs-decode gap is the fp32 gap at smoke size times 2**16, and at
# least one bf16 rounding (2**-8) of the largest logit
BF16_OVER_FP32_EPS = 2.0 ** 16
# the serve phase: JAX's default request shape on granite at full width;
# the watched run serves level 1 (16 experts), whose plane (about 0.43 G
# floats) fits the checkpoint format, whose leaves hold at most 2**32 bytes
# (msgpack's 32-bit lengths, in both packages): level 0's 1.33 G floats do
# not
SERVE_ARGS = ["--arch", MOE_ARCH, "--batch", "4", "--prompt-len", "32",
              "--gen", "32"]
WATCH_LEVEL = 1
# the simulator's main path: the CNN federation of phase 4 under a trace
SIM_ROUNDS, SIM_TRACE_SEED = 8, 3
SIM_HOST_FIELDS = ("level", "time", "active", "dropped", "offline", "masked",
                   "violations", "banked", "unselected", "flushed", "bytes")
# the simulator's launcher in a subprocess (``sim_cli_child``), run from
# the repository's root
SIM_CLI_MAIN = "import sys, chip_smoke; chip_smoke.sim_cli_child(sys.argv[1:])"
# the resume phase: the sync run dies inside the block of this round, the
# async run at this merge event
RESUME_KILL_MID_BLOCK, RESUME_KILL_AT_MERGE = 5, 10
# the train phase: launch/train.py at full OLMo-1B width and depth, as a
# process (``train_child``), one log line a step; then one step at OLMo-1B's
# context with and without remat, from the same weights, at a batch whose
# unrematerialized activations fit the card beside the earlier phases
TRAIN_ARGS = ["--arch", "olmo-1b", "--steps", "20", "--batch", "8",
              "--seq", "128", "--log-every", "1"]
TRAIN_CHILD = "import sys, chip_smoke; chip_smoke.train_child(sys.argv[1:])"
REMAT_B, REMAT_S = 4, 2048
# remat recomputes each superblock's forward: its loss and gradients may
# differ from the stored activations' only by bf16 rounding, at most one
# rounding (2**-8) of each leaf's largest gradient element
REMAT_TOL = 2.0 ** -8
# the mesh phase: sim_run on sim_main's configuration (full-width CNN,
# "mixed", "buffer", blocks of 4 rounds), each rank a process
# (``mesh_child``) in the world the phase starts, as torch.distributed.run
# would; the unsharded run in process
MESH_ARGS = ["--trace", "mixed", "--mar-policy", "buffer",
             "--rounds-per-dispatch", "4", "--rounds", str(SIM_ROUNDS),
             "--participants", "40", "--samples", "2400", "--base-width",
             "1.0", "--compact-to", "4", "--eval-every", "4", "--seed",
             str(SIM_TRACE_SEED)]
MESH_CHILD = "import sys, chip_smoke; chip_smoke.mesh_child(sys.argv[1:])"
# where the run's own response to a one-ulp nudge of its initial
# parameters exceeds the parity tolerance, a mesh run may differ from the
# unsharded one by this many times that response
MESH_NUDGE_FACTOR = 16
PROBE_CHILD = ("import sys, chip_smoke; "
               "chip_smoke.collective_probe_child(sys.argv[1], sys.argv[2])")
# the mesh phase's rank worlds: name -> (mesh shape, tensor-parallel member
# forward); the tp phase reads the tensor-parallel ones
MESH_WORLDS = {"1": ("1", False), "2": ("2", False), "2x2": ("2x2", False),
               "1x2-tp": ("1x2", True), "2x2-tp": ("2x2", True)}
# lm_main's federation schedule; the tp phase runs it on a 1x2 mesh of two
# rank processes (``tp_lm_child``), and at LM_CUT_PARTICIPANTS (capacities
# 4 and 4 where lm_main's are 8 and 8) with the TP forward and with the
# gather path, whose two ranks at the full count would not fit the card
LM_CUT_PARTICIPANTS = 7
# the tp_families phase's xLSTM federation (its unsharded reference, its
# nudged run and its 1x2 world) runs at the cut member count too, to keep
# the script inside its time limit: its chaotic records are held by the
# nudge rule, and its module-level checks are the strong ones
TP_XLSTM_PARTICIPANTS = LM_CUT_PARTICIPANTS
LM_FL = dict(rounds=2, rounds_per_dispatch=2, steps_per_round=2,
             local_batch=4, class_balanced=False, compact_to=2, lr=0.05,
             seed=3)
TP_LM_CHILD = "import sys, chip_smoke; chip_smoke.tp_lm_child(sys.argv[1:])"
# the tp_families phase: a routing choice may differ between the TP
# forward and the unsharded one only where the k-th and (k+1)-th router
# probabilities lie within this (the residual stream under TP is the
# unsharded one summed in another order); jamba's Mamba mixer and MoE FFN
# at full width on 1x2 at module level (a federation of its 13 G-parameter
# superblock does not fit the card), for this many members of (batch,
# sequence) tokens each
TP_NEAR_TIE = 1e-5
TP_MODULE_ARCH = "jamba-v0.1-52b"
# the same module check on xlstm-350m's mLSTM and sLSTM blocks: one member
# step's gradients under the TP forward against the unsharded module's, at
# the parity tolerance (the federation is chaotic, so only module-level
# gradients make a strong check of its TP forward)
TP_XLSTM_ARCH = "xlstm-350m"
TP_MODULE_MEMBERS, TP_MODULE_TOKENS = 2, (2, 256)
# the mLSTM block's check runs again on these further seeds of its
# parameters and inputs: on every seed its TP forward's share of the
# tolerance is held to the unsharded module's share between the card and
# the host (summation-order noise, ROADMAP C10), its gradients' to 1
TP_MLSTM_SEEDS = (4, 5, 6, 7)
# the C8 rule on the card: one member step of OLMo-1B at full width (2 of
# 16 layers) from a bf16 template on 1x2 trains bf16 leaves, its
# gradients held to the unsharded bf16 step's, each leaf's relative L2
# difference within TP_BF16_REL (``tp_bf16_member``); the bound is about
# twice the largest reading of the first run (0.0144; the unsharded bf16
# gradients' own difference from fp32 ones reads 0.0172)
TP_BF16_MODEL = ("olmo-1b", dict(n_layers=2))
TP_BF16_REL = 0.03
TP_MODULE_CHILD = ("import sys, chip_smoke; "
                   "chip_smoke.tp_module_child(sys.argv[1:])")
# the dryrun phase: the compile analysis's own programs (``launch.dryrun``)
# on fake tensors, then for real on the card.  (a) the training step of
# OLMo-1B at full width and depth, bf16, batch 8 x 128, one card; (b) the
# FL round of granite-moe's ``fl_client_config`` on a 2x1 world (two gloo
# ranks on the card), its 256 clients cut to 16 (8 a rank, about 23 GB a
# rank by the analysis), each of 4 x 512 tokens.  Each real peak (the
# bytes allocated above what the process held before its inputs) must lie
# within DRYRUN_BAND times the predicted argument + temporary bytes
DRYRUN_TRAIN = ("olmo-1b", 8, 128)
DRYRUN_FL = dict(arch=MOE_ARCH, mesh=(2, 1), clients=16, local_batch=4,
                 seq=512, steps=1)
DRYRUN_BAND = (0.95, 1.10)
DRYRUN_CHILD = ("import sys, chip_smoke; "
                "chip_smoke.dryrun_fl_child(sys.argv[1:])")
# the dryrun phase's second world: two gloo ranks on the card, mesh 1x2
# (``dryrun_world_child``), the analysis's programs at full width and
# depth, each analysed on fake tensors in a fake world of 2 and run for
# real, in turn: (c) OLMo-1B's decode, fp32, on the "seq" cache (its
# sequence split over the model axis), batch 4 x 8,192; (d) xlstm-350m's
# decode, fp32, on the "hd" cache, batch 4 (its state is O(1): the cache
# length is unused); (e) seamless-m4t-medium's, fp32, on the "hd" cache,
# batch 4 x 512 (64 source positions, ``specs.decode_inputs``' S // 8);
# (f) jamba-v0.1-52b's Mamba mixer alone (d_inner 8192), fp32, one decode
# step on its split cache, batch 4 (the whole jamba does not fit two
# ranks on one card); (g) OLMo-1B's training step under FSDP, bf16,
# DRYRUN_TRAIN's batch.  Each rank's outputs are held against its block
# of the one-device program's on the card: (c)-(f) the logits and cache,
# or the mixer's output and state, at the parity tolerance; (g) each
# updated parameter's and first moment's relative L2 difference, and the
# CE's relative difference, within DRYRUN_FSDP_REL.  That bound is
# TP_BF16_REL, chosen before the first run: bf16 rounds each rank's
# gradient and the two ranks' sum to 2^-8 relative, and C8's bf16 TP step
# read 0.012-0.014 a leaf against the unsharded one (``tp_bf16_member``)
DRYRUN_WORLD = (("c_olmo_decode_seq", "olmo-1b", "seq", 4, 8192),
                ("d_xlstm_decode_hd", "xlstm-350m", "hd", 4, 8),
                ("e_seamless_decode_hd", "seamless-m4t-medium", "hd", 4,
                 512),
                ("f_jamba_mamba_decode", "jamba-v0.1-52b", "hd", 4, 8),
                ("g_olmo_train_fsdp", "olmo-1b", None, 8, 128))
DRYRUN_FSDP_REL = TP_BF16_REL
DRYRUN_WORLD_CHILD = ("import sys, chip_smoke; "
                      "chip_smoke.dryrun_world_child(sys.argv[1:])")
# the configurations lm_main's federation runs (``lm_main_engine``):
# name -> (arch, its cut).  xlstm-350m keeps one superblock (5 mLSTM, 1
# sLSTM) on the chunkwise-parallel mLSTM (the same math): the scan route
# keeps every step's (4, 512, 512) memory per sequence for the backward,
# about 34 GB a layer for 8 members of 4 x 256 tokens.  The templates are
# fp32: the engine trains fp32 planes, whose unsharded unravel gives fp32
# leaves, and a TP plane unravels to the template's dtype (JAX's rules),
# so only an fp32 template lets the tp phases hold the TP forward to the
# unsharded run at the parity tolerance.  The initial draws are rounded
# to the arch's own dtype (bf16) first, as its template rounded them
# before, so every run starts from the same parameters as in earlier PRs
LM_MODELS = {"olmo": ("olmo-1b", dict(n_layers=2, dtype="float32")),
             "granite": (MOE_ARCH, dict(n_layers=2, dtype="float32")),
             "xlstm": ("xlstm-350m", dict(n_layers=6, mlstm_impl="chunk",
                                          dtype="float32"))}


# (phase, seconds since the script started) at each phase line emitted:
# the differences are the phases' wall-clock times, printed at the end
PHASE_ENDS = []
_T0 = time.perf_counter()


def emit(obj):
    if "phase" in obj:
        PHASE_ENDS.append((obj["phase"], time.perf_counter() - _T0))
    print(json.dumps(obj), flush=True)


def time_ms(fn, args_list, iters, *, device_only=True):
    """Mean milliseconds per call over ``iters`` warm calls, cycling through
    ``args_list`` (copies of the inputs, together larger than the L2 cache
    when the inputs are large, so each call reads from device memory).

    ``device_only``: a spin kernel (``torch.cuda._sleep``) holds the stream
    while the host queues every call, so the events bracket device time
    alone; without it, a call whose host side (Python checks, ctypes,
    allocation) outlasts its kernel is timed at the host's pace."""
    import torch
    for a in args_list:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if device_only:
        # about 1 ms of clock cycles a call: longer than the host needs to
        # queue one call of the plain versions; ITERS keeps the queued
        # launches under the CUDA launch-queue depth
        torch.cuda._sleep(int(iters * 2e6))
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def copies(tensors, nbytes):
    n = min(8, max(1, math.ceil(2 * L2_BYTES / max(nbytes, 1))))
    return [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(n - 1)]


def bound(nbytes, ops, peak=FP32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ kernels
def check_fedagg(torch, ops, ref, dev, C, D):
    g = torch.Generator(device=dev).manual_seed(C * 131 + D)
    x = torch.randn(C, D, device=dev, generator=g)
    w = torch.rand(C, device=dev, generator=g)
    w = w / w.sum()
    got = ops.weighted_aggregate(x, w)
    want = ref.weighted_aggregate(x, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=FEDAGG_RTOL,
                               atol=FEDAGG_ATOL)
    return x, w, float((got - want).abs().max())


# the JAX-named wrappers of fedagg at widths that are not multiples of 4:
# aggregate_plane's (C, D) planes and aggregate_tree's leaves
FEDAGG_WRAPPER_PLANES = ((8, 1_000_001), (3, 4_097))
FEDAGG_WRAPPER_TREE = {"w": (8, 1023, 1021), "b": (8, 7), "n": (8, 3, 5)}


def check_fedagg_wrappers(torch, ops, ref, dev):
    """``aggregate_plane`` on planes, and ``aggregate_tree`` on a pytree,
    whose widths are not multiples of 4, against the plain version on the
    same inputs (the wrappers pad the columns for the kernel): each
    call's kernel launches (one) and largest error."""
    from repro_torch.core.tree import tree_leaves
    out = {}
    for C, D in FEDAGG_WRAPPER_PLANES:
        g = torch.Generator(device=dev).manual_seed(C + D)
        x = torch.randn(C, D, device=dev, generator=g)
        w = torch.rand(C, device=dev, generator=g)
        n = ops.weighted_aggregate.launches
        got = ops.aggregate_plane(x, w)
        launches = ops.weighted_aggregate.launches - n
        want = ref.weighted_aggregate(x, w)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=FEDAGG_RTOL,
                                   atol=FEDAGG_ATOL)
        out[f"aggregate_plane {C}x{D}"] = {
            "launches": launches,
            "max_abs_err": float((got - want).abs().max())}
    g = torch.Generator(device=dev).manual_seed(7)
    stack = {k: torch.randn(*v, device=dev, generator=g)
             for k, v in FEDAGG_WRAPPER_TREE.items()}
    w = torch.rand(8, device=dev, generator=g)
    n = ops.weighted_aggregate.launches
    got = ops.aggregate_tree(stack, w)
    launches = ops.weighted_aggregate.launches - n
    err = 0.0
    for k, x in stack.items():
        want = ref.weighted_aggregate(x.reshape(8, -1), w).reshape(
            x.shape[1:])
        torch.testing.assert_close(got[k], want, rtol=FEDAGG_RTOL,
                                   atol=FEDAGG_ATOL)
        err = max(err, float((got[k] - want).abs().max()))
    D = sum(x[0].numel() for x in tree_leaves(stack))
    out[f"aggregate_tree 8x{D}"] = {"launches": launches,
                                    "max_abs_err": err}
    bad = {k: v for k, v in out.items() if v["launches"] != 1}
    if bad:
        raise AssertionError(f"fedagg wrappers: not one launch {bad}")
    return out


def time_fedagg(torch, ops, ref, x, w):
    C, D = x.shape
    nbytes = (C * D + C + D) * 4
    args = copies((x, w), nbytes)
    iters = ITERS_LARGE if nbytes > L2_BYTES else ITERS
    b_ms, b_by = bound(nbytes, 2 * C * D)
    return {"ms": time_ms(ops.weighted_aggregate, args, iters),
            "call_ms": time_ms(ops.weighted_aggregate, args, iters,
                               device_only=False),
            "plain_ms": time_ms(ref.weighted_aggregate, args, iters),
            "library_ms": time_ms(lambda p, v: torch.mv(p.t(), v), args,
                                  iters),
            "bound_ms": b_ms, "bound_by": b_by}


def check_distill(torch, ops, ref, dev, N, V, dtype, T=2.0, alpha=0.3):
    g = torch.Generator(device=dev).manual_seed(N * 7 + V)
    s = (torch.randn(N, V, device=dev, generator=g) * 3).to(dtype)
    t = (torch.randn(N, V, device=dev, generator=g) * 3).to(dtype)
    y = torch.randint(0, V, (N,), device=dev, generator=g, dtype=torch.int32)
    rows = ops.kd_loss_rows(s, t, y, T=T, alpha=alpha)
    again = ops.kd_loss_rows(s, t, y, T=T, alpha=alpha)
    want_rows = ref.kd_loss_rows(s, t, y, T=T, alpha=alpha)
    torch.cuda.synchronize()
    if not torch.equal(rows, again):
        raise AssertionError(f"distill ({N}, {V}, {dtype}): two calls on the "
                             "same inputs gave different bits")
    got, want = float(rows.mean()), float(want_rows.mean())
    # tests/test_distill.py: 1e-3 relative on the mean in fp32, 5e-2 in bf16
    tol = (5e-2 if dtype == torch.bfloat16 else 1e-3) * max(1.0, abs(want))
    if not (math.isfinite(got) and abs(got - want) < tol):
        raise AssertionError(f"distill ({N}, {V}, {dtype}): kernel {got} vs "
                             f"plain {want}, tolerance {tol}")
    return (s, t, y), float((rows - want_rows).abs().max())


def time_distill(torch, ops, ref, args):
    s, t, y = args
    N, V = s.shape
    nbytes = 2 * N * V * s.element_size() + N * y.element_size() + N * 4
    reps = copies(args, nbytes)
    iters = ITERS_LARGE if nbytes > L2_BYTES else ITERS
    design = "warp-per-row" if V <= ops.SMALL_V else "split"
    b_ms, b_by = bound(nbytes, DISTILL_OPS_PER_LOGIT[design] * N * V)
    splits, chunk = ops.split_plan(N, V)
    return {"ms": time_ms(ops.kd_loss_rows, reps, iters),
            "call_ms": time_ms(ops.kd_loss_rows, reps, iters,
                               device_only=False),
            "plain_ms": time_ms(ref.kd_loss_rows, reps, iters),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "design": design, "splits": splits, "chunk": chunk,
            "kernels_per_call": 1 if design == "warp-per-row" else 2,
            "bit_identical_repeat": True}


def attn_pairs(S, causal, window):
    """Unmasked (query, key) pairs of one row of heads: the work these
    inputs need (tiles the kernel skips are not counted)."""
    total = 0
    for i in range(S):
        lo = max(0, i - window + 1) if window > 0 else 0
        hi = i + 1 if causal else S
        total += hi - lo
    return total


def check_flash(torch, ops, ref, dev, case):
    """Kernel against ``ref.attention_bh_gqa`` on one case, then timed."""
    BH, KV_rows, S, hd, H = case["bh"], case["kv_rows"], case["S"], \
        case["hd"], case["H"]
    dtype = getattr(torch, case["dtype"])
    kw = dict(causal=case["causal"], window=case["window"],
              softcap=case["softcap"])
    g = torch.Generator(device=dev).manual_seed(BH * 7 + S + hd)
    q = torch.randn(BH, S, hd, device=dev, generator=g).to(dtype)
    k = torch.randn(KV_rows, S, hd, device=dev, generator=g).to(dtype)
    v = torch.randn(KV_rows, S, hd, device=dev, generator=g).to(dtype)
    got = ops.flash_attention_bh(q, k, v, heads=H, **kw)
    want = ref.attention_bh_gqa(q, k, v, heads=H, **kw)
    torch.cuda.synchronize()
    rtol, atol = FLASH_TOL[case["dtype"]]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    err = float((got.float() - want.float()).abs().max())
    del got, want
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    flops = 4 * attn_pairs(S, kw["causal"], kw["window"]) * hd * BH
    variant = ops._variant(hd, dtype)
    peak = (BF16_FLOPS_PER_S if dtype == torch.bfloat16 else
            TF32X3_FLOPS_PER_S if variant == "tf32x3" else FP32_FLOPS_PER_S)
    b_ms, b_by = bound(nbytes, flops, peak)
    reps = copies((q, k, v), nbytes)
    iters = ITERS_LARGE if nbytes > L2_BYTES else ITERS

    def kernel(q, k, v):
        return ops.flash_attention_bh(q, k, v, heads=H, **kw)

    def plain(q, k, v):
        return ref.attention_bh_gqa(q, k, v, heads=H, **kw)

    out = dict(case, route="simt" if variant == "simt" else "tc",
               variant=variant,
               max_abs_err=err, tolerance={"rtol": rtol, "atol": atol},
               bound_ms=b_ms, bound_by=b_by, peak=PEAK_NAMES[peak],
               ms=time_ms(kernel, reps, iters),
               call_ms=time_ms(kernel, reps, iters, device_only=False),
               plain_ms=time_ms(plain, reps, min(iters, 10)))
    if dtype == torch.float32:
        # the bound at the CUDA-core fp32 peak, as the simt kernel had it
        out["bound_cuda_core_ms"] = bound(nbytes, flops)[0]
    if kw["softcap"] > 0:
        out["library_ms"] = None   # no one PyTorch call applies a softcap
    else:
        B = BH // H
        KV = KV_rows // B
        mask = None
        if kw["window"] > 0:
            i = torch.arange(S, device=dev)
            mask = ((i[None, :] <= i[:, None]) if kw["causal"] else
                    torch.ones(S, S, dtype=torch.bool, device=dev))
            mask = mask & ((i[:, None] - i[None, :]) < kw["window"])

        def library(q, k, v):
            return torch.nn.functional.scaled_dot_product_attention(
                q.view(B, H, S, hd), k.view(B, KV, S, hd),
                v.view(B, KV, S, hd), attn_mask=mask,
                is_causal=kw["causal"] and mask is None,
                enable_gqa=KV != H)

        out["library_ms"] = time_ms(library, reps, iters)
    del reps, q, k, v
    torch.cuda.empty_cache()
    return out


# the grouped GEMM kernels' largest error against ref.py in fp64, over the
# fp64 product's largest entry: the rows kernels reduce over d or f (at
# most 1,024 products), the weight gradient over a group's rows (up to a
# member's 8,192), so its fp32 sums carry more rounding; a row or a group
# out of place reads near 1
GG_TOL = {"rows": 1e-5, "rows_transposed": 1e-5, "wgrad": 1e-4}
GG_CELL, GG_SEED = "granite_moe.fl14_kd", 2_147_483_929


def check_grouped_gemm(torch, ops, ref, dev, C, E, d, f, rows, seed):
    """One level's three kinds of launch (C members' ``rows`` routed rows
    each over E experts of width f, C * E groups): rows d -> f (the gate
    and up products), transposed rows f -> d (their dX) and the weight
    gradient (their dW).  Skewed offsets: member 0 sends every row to
    expert 1 and none to the others, the rest draw their experts' shares
    from Dirichlet(0.3).  Each against ref.py in fp64 (the per-group fp32
    plain version's own error beside it), one launch a call by the
    registry's count, then timed with the plain version and the bound."""
    import numpy as np
    from bench.kinds.moe import rows_work, wgrad_work
    from repro_torch import obs
    rng = np.random.default_rng(seed)
    cnt = np.concatenate([np.eye(E, dtype=np.int64)[1] * rows] + [
        rng.multinomial(rows, rng.dirichlet([0.3] * E))
        for _ in range(C - 1)])
    off = torch.as_tensor(np.concatenate([[0], np.cumsum(cnt)]),
                          device=dev)
    M, G = int(cnt.sum()), C * E
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(M, d, device=dev, generator=g)
    w = torch.randn(G, d, f, device=dev, generator=g) * d ** -0.5
    dy = torch.randn(M, f, device=dev, generator=g)
    # (kernel, plain version, inputs, (bytes, operations) as the benchmark
    # counts a launch)
    cases = {"rows": (ops.grouped_rows, ref.grouped_rows, (x, w, off),
                      rows_work(M, d, f, G)),
             "rows_transposed": (
                 lambda a, b, o: ops.grouped_rows(a, b, o, True),
                 lambda a, b, o: ref.grouped_rows(a, b, o, True),
                 (dy, w, off), rows_work(M, f, d, G)),
             "wgrad": (ops.grouped_wgrad, ref.grouped_wgrad, (x, dy, off),
                       wgrad_work(M, d, f, G))}
    out = {"C": C, "E": E, "d": d, "f": f, "M": M, "G": G,
           "rows_per_group": {"max": int(cnt.max()),
                              "empty": int((cnt == 0).sum())}}
    for kind, (kernel, plain, args, (nbytes, ops_n)) in cases.items():
        with obs.observing(obs.make_observability(trace=False)) as o:
            got = kernel(*args)
        launches = int(o.registry.counter("moe/grouped_gemm_launches").value)
        want = plain(*(a.double() if a.is_floating_point() else a
                       for a in args))
        scale = float(want.abs().max())
        err = float((got.double() - want).abs().max()) / scale
        plain_err = float((plain(*args).double() - want).abs().max()) / scale
        del got, want
        if err > GG_TOL[kind] or launches != 1:
            raise AssertionError(f"grouped_gemm {kind} at C {C}, E {E}, d "
                                 f"{d}, f {f}: error {err} of the largest "
                                 f"entry (tolerance {GG_TOL[kind]}), "
                                 f"{launches} launches")
        b_ms, b_by = bound(nbytes, ops_n)
        iters = ITERS_LARGE if nbytes > L2_BYTES else ITERS
        reps = copies(args, nbytes)
        out[kind] = {
            "max_rel_err": err, "plain_max_rel_err": plain_err,
            "tolerance": GG_TOL[kind], "launches": launches,
            "ms": time_ms(kernel, reps, iters),
            "plain_ms": time_ms(plain, reps, min(iters, 10)),
            # no PyTorch call computes an fp32 grouped product
            "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by,
            "peak": PEAK_NAMES[FP32_FLOPS_PER_S],
            "bound_tf32_ms": max(nbytes / HBM_BYTES_PER_S,
                                 ops_n / 495e12) * 1e3}
        del reps
    del x, w, dy
    torch.cuda.empty_cache()
    return out


def phase_grouped_gemm(torch, dev):
    """The grouped GEMM kernels at the benchmark cell ``GG_CELL``'s shapes,
    then the cell's main path: its configuration, traffic and engine
    (``bench/``), one cold ``train()`` with a fresh registry current, the
    launches and routed rows the program counts against what the code
    implies (and ``bench/kinds/moe``'s count).  Emits two lines; returns
    (the kernels' cases by level, the main path's record)."""
    from bench import manifest, program, timeline
    from bench import traffic as traffic_gen
    from bench.kinds import moe as moe_kind
    from repro_torch.core.scaling import compress_config
    from repro_torch.kernels.grouped_gemm import ops, ref
    from repro_torch.obs import make_observability
    cell = manifest.cell(GG_CELL)
    cfg, traffic = cell["config"], cell["traffic"]
    fl, S = traffic["fl"], traffic["seq"]
    L, K, B = cfg["n_layers"], cfg["experts_per_tok"], fl["local_batch"]
    R, steps = fl["rounds"], fl["steps_per_round"]
    fed = traffic_gen.generate(traffic, cfg, GG_SEED)
    eng = program.build_engine(cfg, traffic, fed, GG_SEED, dev,
                               timeline.Spans(torch, on=False, sync=True))
    lay = {int(l): v for l, v in program.layout(eng).items()}
    base = moe_kind.model_config(cfg)
    cases = {}
    for level, v in sorted(lay.items()):
        lc = compress_config(base, cfg["alpha"], level)
        cases[level] = check_grouped_gemm(
            torch, ops, ref, dev, v["capacity"], lc.n_experts, lc.d_model,
            lc.d_ff, B * S * K, GG_SEED + level)
    emit({"phase": "kernels", "kernel": "grouped_gemm", "cell": GG_CELL,
          "cases_by_level": {str(l): c for l, c in cases.items()}})
    want_launches = want_rows = 0
    n_test = fed["n_test"]
    for level, v in lay.items():
        c, kd = v["capacity"], fl["use_kd"] and level > 0
        # a member step: three products forward, their three dX and three
        # dW; a round's evaluation three; a KD round's teacher forward three
        want_launches += L * (9 * R * steps + 3 * R + (3 * R if kd else 0))
        want_rows += L * K * S * (R * steps * c * B + R * n_test
                                  + (R * steps * c * B if kd else 0))
    work = moe_kind.grouped_gemm_launches(
        cfg, traffic, {l: v["capacity"] for l, v in lay.items()}, n_test)
    eng.obs = make_observability(trace=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng.train(fed["test"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counters = eng.obs.registry.snapshot()["counters"]
    rec = {"phase": "granite_cell_main", "cell": GG_CELL, "seed": GG_SEED,
           "layout": {str(l): v for l, v in lay.items()},
           "grouped_gemm_launches": int(counters.get(
               "moe/grouped_gemm_launches", 0)),
           "expected_launches": want_launches,
           "benchmark_count": sum(n for n, _, _ in work),
           "routed_rows": int(counters.get("moe/routed_rows", 0)),
           "expected_routed_rows": want_rows,
           "cold_train_seconds": secs,
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    del eng, fed
    torch.cuda.empty_cache()
    if not (rec["grouped_gemm_launches"] == want_launches
            == rec["benchmark_count"]
            and rec["routed_rows"] == want_rows):
        raise AssertionError(f"granite cell main path: {rec}")
    emit(rec)
    return cases, rec


# ------------------------------------------------------------------ main path
def federation(n_part, samples, seed):
    import numpy as np
    from repro_torch.core.resources import TABLE_III, participants_from_matrix
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.data.synthetic import make_classification, \
        train_test_split
    ds = make_classification("synth-mnist", samples, seed=seed)
    train, test = train_test_split(ds)
    idx = dirichlet_partition(train.y, n_part, alpha=1.0, seed=seed)
    V = TABLE_III
    if n_part != 40:
        V = TABLE_III[np.random.default_rng(seed).integers(0, 40, n_part)]
    parts = participants_from_matrix(V, n_data=[len(p) for p in idx])
    cd = [{"x": train.x[p], "y": train.y[p]} for p in idx]
    return parts, cd, {"x": test.x, "y": test.y}


def engines(srv, torch):
    """Two engine classes for the smoke: ``Recording`` keeps each block's
    per-round member losses (``block_losses``) for the checks, and
    ``TokenFedRAC`` adds, for token-only data, the JAX tests' hooks
    (tests/test_system.py, tests/test_equivalence_matrix.py):
    ``_batch_from_gathered`` adds the KD hard label ``y = tokens[..., -1]``
    and evaluation is -loss."""

    class Recording(srv.FedRAC):
        def setup(self):
            self.block_losses = []
            return super().setup()

        def dispatch_rounds(self, *args, **kw):
            out = super().dispatch_rounds(*args, **kw)
            self.block_losses.append((args[0], out.losses.cpu().tolist()))
            return out

    class TokenFedRAC(Recording):
        def _batch_from_gathered(self, g):
            return {"tokens": g["tokens"], "y": g["tokens"][:, :, -1]}

        def evaluate(self, level, params, test):
            test = self._to_device(test)
            with torch.no_grad():
                loss, _ = self.family.loss_and_logits(level, params, test)
            return -float(loss)

    return Recording, TokenFedRAC


def lm_federation(n_part, vocab, corpus_tokens, seq, seed):
    """Token-only federation: a Markov corpus cut into one chunk per
    participant; each member holds 16 windows of ``seq`` tokens."""
    import numpy as np
    from repro_torch.core.resources import TABLE_III, participants_from_matrix
    from repro_torch.data.synthetic import lm_batches, make_lm_corpus
    corpus = make_lm_corpus(vocab, corpus_tokens, seed=seed)
    cd = [{"tokens": lm_batches(ch, 16, seq, 1, seed=i)[0]}
          for i, ch in enumerate(np.array_split(corpus, n_part))]
    V = TABLE_III[np.random.default_rng(seed).integers(0, 40, n_part)]
    parts = participants_from_matrix(V, n_data=[len(c["tokens"])
                                                for c in cd])
    return parts, cd, {"tokens": lm_batches(corpus, 32, seq, 1, seed=99)[0]}


def lm_main_engine(srv, torch, device, mesh=None, nudge=0.0,
                   participants=LM_PARTICIPANTS, tp_forward=True,
                   model="olmo"):
    """lm_main's federation at full OLMo-1B width (two of its 16 layers,
    attention on the flash route), set up: (base config, FL config,
    engine, test tokens, seconds to draw the corpus).  ``nudge`` scales
    every initial parameter by (1 + nudge) in fp32, the dtype the engine
    trains its planes in (a bf16 leaf would round the nudge away);
    ``participants`` cuts the member count, ``tp_forward`` picks a 2D
    mesh's member forward, ``model`` the configuration (``LM_MODELS``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.families import lm_family
    from repro_torch.core.tree import tree_map
    from repro_torch.models.layers import torch_dtype
    arch, kw = LM_MODELS[model]
    lm_base = get_config(arch).replace(attn_impl="pallas", **kw)
    draw_dtype = torch_dtype(get_config(arch).dtype)
    lm_cfg = srv.FLConfig(**LM_FL, tp_forward=tp_forward)
    t0 = time.perf_counter()
    lparts, lcd, ltest = lm_federation(participants, lm_base.vocab_size,
                                       LM_CORPUS_TOKENS, LM_SEQ, 3)
    corpus_s = time.perf_counter() - t0
    _, TokenFedRAC = engines(srv, torch)

    class Engine(TokenFedRAC):
        def init_params(self, level):
            p = tree_map(lambda x: x.to(draw_dtype).to(torch.float32),
                         super().init_params(level))
            if not nudge:
                return p
            return tree_map(lambda x: x * (1.0 + nudge), p)

    lm = Engine(lparts, lcd, lm_family(lm_base, 0.5), lm_cfg,
                classes=lm_base.padded_vocab, device=device,
                mesh=mesh).setup()
    return lm_base, lm_cfg, lm, ltest, corpus_s


def profile_train(torch, eng, test, match):
    """The warm ``train()`` once on the host clock and once traced; device
    time by kernel from the trace."""
    t0 = time.perf_counter()
    eng.train(test)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        eng.train(test)
        torch.cuda.synchronize()
    prof_s = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies, sets): the host op rows
        # repeat the device time of the kernels they launch
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.self_device_time_total, e.count, e.key[:90]))
    rows.sort(reverse=True)
    device_s = sum(r[0] for r in rows) / 1e6
    return {"warm_train_seconds": warm_s, "profiled_train_seconds": prof_s,
            "device_seconds": device_s,
            # both from the profiled run: tracing adds time to every launch on
            # the host and on the device, so the share is approximate
            "device_busy_share_profiled": device_s / prof_s if rows else None,
            "port_kernels": [{"name": k, "calls": c, "ms": us / 1e3}
                             for us, c, k in rows
                             if any(m in k for m in match)],
            "top_device_ops": [{"name": k, "calls": c, "ms": us / 1e3}
                               for us, c, k in rows[:12]]}


def check_finite(torch, eng, block_losses, kd_report):
    for level, losses in block_losses:
        if not all(math.isfinite(x) for row in losses for x in row):
            raise AssertionError(f"a dispatched round of cluster {level} "
                                 "produced a non-finite member loss")
    for l, p in eng.cluster_params.items():
        if not bool(torch.isfinite(eng.plane_of(l, p)).all()):
            raise AssertionError(f"cluster {l} ended with a non-finite plane")
    if not all(math.isfinite(v) for v in kd_report.values()):
        raise AssertionError(f"non-finite distillation loss {kd_report}")


# ------------------------------------------------------------------ simulator
def sim_host_rows(report):
    """Every record's host fields (numpy float64 arithmetic on the host):
    the part of the telemetry that must be equal, not close."""
    return [(r.round, r.t_start, r.duration, list(r.events),
             [tuple(getattr(c, f) for f in SIM_HOST_FIELDS)
              for c in r.clusters]) for r in report.rows]


def expected_fedagg_launches(rows, terminal, compressions, banked):
    """The fedagg launches a simulator run on the dispatch path implies,
    from its records ``rows`` (``SimReport.rows``), sync or async (an async
    block runs at its cluster's own round cursor, and its rounds are filed
    as the same per-round records):
    - each round of a cluster that dispatched (a live member, or a banked
      one) aggregates its member plane once, and once more to merge the
      bank when its block carries one (``banked``: FLConfig(aggregation=
      "buffered") gives every block a bank);
    - each round in which no member was live but ripe bank entries
      flushed ran one anchored flush (one contraction over the entries);
    - the terminal flush runs once per level with entries left
      (``terminal``: level -> entries; it adds them to that level's last
      record, which is taken off again here);
    - each bank compression (``agg/bank_compressions``) runs once.
    The one-round path (R = 1) aggregates parameter trees: no launch."""
    last = {c.level: r.round for r in rows for c in r.clusters}
    n = 0
    for r in rows:
        for c in r.clusters:
            live = bool(c.active)
            if live or c.banked:
                n += 2 if banked else 1
            flushed = c.flushed - (terminal.get(c.level, 0)
                                   if r.round == last[c.level] else 0)
            if not live and flushed > 0:
                n += 1
    return n + len(terminal) + compressions


def sim_classes(srv, HeterogeneitySim):
    """Engine and simulator that record what the launch count and the
    kernel checks need: the (rows, D_pad) shapes fedagg is given (member
    and bank planes of each block, and the anchored flushes' entries), and
    the entries the terminal flush merged per level."""

    class ShapeFedRAC(srv.FedRAC):
        def setup(self):
            self.fedagg_shapes = set()
            return super().setup()

        def dispatch_rounds(self, level, members, *args, **kw):
            self.fedagg_shapes.add((self._capacity(len(members)),
                                    self.plane_spec(level).d_pad))
            return super().dispatch_rounds(level, members, *args, **kw)

    class CountingSim(HeterogeneitySim):
        conservation_checks = 0

        def _check_conservation(self, s, n, r):
            self.conservation_checks += 1
            super()._check_conservation(s, n, r)

        def _anchored_merge_plane(self, cur, entries, r, lvl):
            self.fl.fedagg_shapes.add((len(entries), cur.shape[0]))
            return super()._anchored_merge_plane(cur, entries, r, lvl)

        def _terminal_flush(self, params, rounds, report, merge=None):
            self.terminal = {l: len(e) for l, e in self._bank.items() if e}
            super()._terminal_flush(params, rounds, report, merge)

    return ShapeFedRAC, CountingSim


def sim_host_rows_per_cluster(report):
    """``sim_host_rows`` without each record's ``t_start``: in async mode it
    is the earliest cluster clock, which equals the sync engine's barrier
    clock only with one cluster."""
    return [r[:1] + r[2:] for r in sim_host_rows(report)]


def fedagg_record_path(report_out):
    return Path(str(report_out) + ".fedagg.json")


def sim_cli_child(argv):
    """One launcher process of the resume phase: ``sim_run.main(argv)``
    through ``launcher_sim_run`` (run-to-run deterministic cuDNN, since the
    phase compares runs bit for bit, and TF32 off, as in the parent).  A
    process that runs to its end writes beside its ``--report-out``
    (``fedagg_record_path``) the (rows, columns) shapes fedagg was given,
    its launches in ``sim.run`` and, in a run that did not resume, the
    launches its records imply."""
    shapes = set()
    _, _, launches, expected = launcher_sim_run(argv, shapes)
    rec = {"launches": launches, "shapes": sorted(shapes)}
    if "--resume" not in argv:
        rec["expected_launches"] = expected
    if "--report-out" in argv:
        with open(fedagg_record_path(argv[argv.index("--report-out") + 1]),
                  "w") as f:
            json.dump(rec, f)


def resume_runs(base, out_dir, env, compare_reports, manager_cls):
    """The resume phase's six launcher processes on the flags ``base``: a
    sync dispatch run (control; killed by SIGKILL inside the block of round
    ``RESUME_KILL_MID_BLOCK``; resumed) and an async run (control; killed at
    merge event ``RESUME_KILL_AT_MERGE``; its newest checkpoint
    garbage-corrupted, then resumed from the one before).  Raises unless
    each process exits as it must, each resumed report equals its
    control's, each control launched fedagg as often as its records imply
    and each resumed run launched it; returns what the phase prints, with
    each finished process's fedagg record (its shapes are checked by the
    caller).  The sync and the async chain run side by side on the card,
    so their processes' seconds overlap."""
    from concurrent.futures import ThreadPoolExecutor
    procs = []

    def cli(tag, flags, expect):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", SIM_CLI_MAIN] + base + flags,
            capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
        procs.append({"run": tag, "flags": flags,
                      "exit_code": proc.returncode,
                      "seconds": time.perf_counter() - t0})
        if proc.returncode != expect:
            raise AssertionError(f"resume {tag}: exit {proc.returncode}, "
                                 f"expected {expect}: "
                                 f"{proc.stderr[-2000:]}")
        return proc

    out, fedagg = {}, {}

    def chain(mode, extra, kill):
        ck = str(out_dir / f"ckpt_{mode}")
        ctrl, res = (str(out_dir / f"{mode}_{t}.json")
                     for t in ("control", "resumed"))
        cli(f"{mode}_control", extra + ["--report-out", ctrl], 0)
        cli(f"{mode}_killed", extra + ["--ckpt-dir", ck] + kill, -9)
        steps = manager_cls(ck).steps()
        resume = ["--ckpt-dir", ck, "--resume", "--report-out", res]
        if mode == "async":
            resume += ["--corrupt-ckpt", "garbage"]
        proc = cli(f"{mode}_resumed", extra + resume, 0)
        if mode == "async" and (f"skipping checkpoint step {steps[-1]}"
                                not in proc.stderr):
            raise AssertionError("the resumed async run did not skip the "
                                 f"corrupted step {steps[-1]}: "
                                 f"{proc.stderr[-2000:]}")
        for tag, path in (("control", ctrl), ("resumed", res)):
            with open(fedagg_record_path(path)) as f:
                rec = json.load(f)
            fedagg[f"{mode}_{tag}"] = rec
            want = rec.get("expected_launches", 1)
            if (rec["launches"] != want if tag == "control"
                    else rec["launches"] < want):
                raise AssertionError(f"resume {mode}_{tag}: fedagg launched "
                                     f"{rec['launches']} times, expected "
                                     f"{'' if tag == 'control' else '>= '}"
                                     f"{want}")
        diffs = compare_reports(ctrl, res)
        with open(res) as f:
            crc = json.load(f)["params_crc32"]
        if diffs or not crc:
            raise AssertionError(f"resumed {mode} report differs from the "
                                 f"control: {diffs[:10]}")
        with open(Path(ck) / "MANIFEST.json") as f:
            kept = json.load(f)["checkpoints"]
        out[mode] = {"steps_kept_at_kill": steps,
                     "resumed_from": steps[-2] if mode == "async"
                     else steps[-1],
                     "compare_reports_diffs": len(diffs),
                     "params_crc32": crc,
                     "checkpoint_bytes": {
                         str(e["step"]): sum(v["bytes"] for v in
                                             e["files"].values())
                         for e in kept}}

    with ThreadPoolExecutor(2) as pool:
        for done in [pool.submit(chain, *c) for c in (
                ("sync", [], ["--kill-mid-block",
                              str(RESUME_KILL_MID_BLOCK)]),
                ("async", ["--mode", "async"],
                 ["--kill-at-round", str(RESUME_KILL_AT_MERGE)]))]:
            done.result()
    # seconds per checkpoint write: the newest sync payload, written again
    _, meta, arrays = manager_cls(str(out_dir / "ckpt_sync")).load_latest()
    mgr = manager_cls(str(out_dir / "write_timing"), keep=1)
    write_s = []
    for i in range(3):
        t0 = time.perf_counter()
        mgr.save(i, meta, arrays)
        write_s.append(time.perf_counter() - t0)
    out["write_seconds"] = write_s
    out["write_bytes"] = sum(a.nbytes for a in arrays.values())
    out["processes"] = procs
    out["fedagg"] = fedagg
    return out


# ------------------------------------------------------------------ comparison path
def table2_sweep(C, R, device):
    """``benchmarks/bench_tables.py``'s Table II, here: the Dunn index at
    k = 2..6 on Table III under the paper's λ for single-restart k-means
    (seed 3; its Lloyd loop on ``device``), DBSCAN and OPTICS (host numpy),
    with each method's labels, best k and seconds."""
    import numpy as np
    Vb = R.unit_normalize(R.TABLE_III)
    S = R.similarity_matrix(Vb, R.LAMBDA_PAPER)
    X = Vb * np.sqrt(np.asarray(R.LAMBDA_PAPER))
    out = {}
    for method in ("kmeans", "dbscan", "optics"):
        t0 = time.perf_counter()
        dis, labels = {}, {}
        for k in range(2, 7):
            if method == "kmeans":
                lab, _ = C.kmeans(X, k, seed=3, restarts=1, device=device)
            elif method == "dbscan":
                lab = C.dbscan_at_k(X, k)
            else:
                lab = C.optics_at_k(X, k)
            dis[str(k)] = None if lab is None else C.dunn_index(S, lab)
            labels[str(k)] = None if lab is None else lab.tolist()
        out[method] = {
            "seconds": time.perf_counter() - t0, "di": dis, "labels": labels,
            "best_k": int(max((v, k) for k, v in dis.items()
                              if v is not None)[1])}
    return out


def fleet_rows(report):
    """Every field of every ``FleetRoundRecord``, as plain lists."""
    return [{f: (v.tolist() if hasattr(v, "tolist") else v)
             for f, v in vars(r).items()} for r in report.rows]


def fleet_resume(n, out_dir, cfg_kw, device):
    """The fleet simulator at ``n`` participants: uninterrupted, then killed
    at round boundary 5 (in process) with a checkpoint every 2 rounds,
    then resumed by a fresh simulator.  Returns the two (rows, summary,
    levels) and the seconds of each run."""
    from repro_torch.ckpt.run_state import make_checkpointer
    from repro_torch.core.resources import Fleet
    from repro_torch.sim import (FleetSim, FleetSimConfig, make_fleet_trace,
                                 sample_profiles)
    from repro_torch.sim.faults import (FaultInjector, FaultPlan,
                                        SimulatedCrash)
    V = sample_profiles(n, seed=3)
    trace = make_fleet_trace("mixed", n, cfg_kw["rounds"], seed=3)

    def one(ckpt=False, resume=False, kill=None):
        ck = (make_checkpointer(str(out_dir), every=2, resume=resume)
              if ckpt else None)
        sim = FleetSim(Fleet.from_matrix(V.copy()), trace,
                       FleetSimConfig(**cfg_kw), checkpoint=ck,
                       faults=(FaultInjector(FaultPlan(
                           kill_at_round=kill, raise_instead=True))
                           if kill is not None else None), device=device)
        t0 = time.perf_counter()
        try:
            rep = sim.run()
        except SimulatedCrash:
            return None, time.perf_counter() - t0
        return ((fleet_rows(rep), rep.summary(), rep.levels.tolist()),
                time.perf_counter() - t0)

    shutil.rmtree(out_dir, ignore_errors=True)
    ctrl, ctrl_s = one()
    killed, killed_s = one(ckpt=True, kill=5)
    if killed is not None:
        raise AssertionError("the fleet run was not killed at round 5")
    resumed, resumed_s = one(ckpt=True, resume=True)
    return ctrl, resumed, {"control": ctrl_s, "killed": killed_s,
                           "resumed": resumed_s}


def baseline_runs(bl, loss_fn, tree_map, parts, cd, test, where, bcfg,
                  init, hetero_init):
    """The four baselines on ``where`` from the given initial weights:
    name -> (params on the CPU, accuracy curve); Oort's chosen pids under
    ``"oort_chosen"``."""
    def moved(p):
        return tree_map(lambda x: x.to(where), p)

    def host(p):
        return tree_map(lambda x: x.detach().cpu(), p)

    out = {}
    for name, fn in (("fedavg", bl.fedavg), ("fedprox", bl.fedprox)):
        p, h = fn(loss_fn, moved(init), parts, cd, test, bcfg)
        out[name] = (host(p), h)
    # Oort's choices, read through the selection hook of ``_run_rounds``
    chosen, real = [], bl._run_rounds

    def spy(*a, select=None, **kw):
        def logged(ps, losses, r):
            picked = select(ps, losses, r)
            chosen.append([q.pid for q in picked])
            return picked
        return real(*a, select=logged, **kw)

    bl._run_rounds = spy
    try:
        p, h = bl.oort(loss_fn, moved(init), parts, cd, test, bcfg,
                       flops_per_sample=1e6, model_bytes=2e5)
    finally:
        bl._run_rounds = real
    out["oort"] = (host(p), h)
    out["oort_chosen"] = chosen
    levels = {p.pid: min(2, 3 * i // len(parts)) for i, p in enumerate(parts)}
    p, h = bl.heterofl(parts, cd, levels, test, bcfg, in_channels=1,
                       classes=10, levels=3, base_width=0.125,
                       init_params=hetero_init, device=where)
    out["heterofl"] = (host(p), h)
    return out


def load_example(name):
    """An example file of ``examples/`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ----------------------------------------------------------------- training
def train_child(argv):
    """The train phase's process: ``repro_torch.launch.train.main(argv)``
    with TF32 off, as in the parent.  Besides the launcher's lines it
    prints one JSON line: the peak device memory, the seconds of each
    step's gradient clipping and optimizer update (each fenced by a
    synchronize), the checkpoint's bytes and write seconds, and whether
    the restored leaves equal the trained ones bit for bit."""
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.ckpt import checkpoint
    from repro_torch.launch import train
    from repro_torch.optim import optimizers
    split = {"clip": [], "update": []}

    def fenced(fn, key):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            split[key].append(time.perf_counter() - t0)
            return out
        return run

    get_optimizer = optimizers.get

    def timed_optimizer(name, **kw):
        opt = get_optimizer(name, **kw)
        return optimizers.Optimizer(opt.init, fenced(opt.update, "update"))

    optimizers.clip_by_global_norm = fenced(optimizers.clip_by_global_norm,
                                            "clip")
    optimizers.get = timed_optimizer
    saved = {}
    save_step = checkpoint.save_step

    def timed_save_step(ckpt_dir, step, tree, keep=3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_step(ckpt_dir, step, tree, keep)
        saved.update(path=path, seconds=time.perf_counter() - t0,
                     bytes=os.path.getsize(path))
        restored = checkpoint.restore(path)
        leaves = checkpoint._flatten(tree)
        saved["restored_equal"] = len(restored) == len(leaves) and all(
            torch.equal(torch.as_tensor(restored[k]), v.detach().cpu())
            for k, v in leaves)
        saved["dtypes"] = sorted({str(v.dtype) for _, v in leaves})
        return path

    checkpoint.save_step = timed_save_step
    from repro_torch.kernels.distill import ops as d_ops
    from repro_torch.kernels.fedagg import ops as f_ops
    from repro_torch.kernels.flash import ops as a_ops
    kernels = {"fedagg": f_ops.weighted_aggregate,
               "distill": d_ops.kd_loss_rows,
               "flash": a_ops.flash_attention_bh}
    for k in kernels.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses = train.main(argv)
    print(json.dumps({"peak_mem_bytes": torch.cuda.max_memory_allocated(),
                      "ckpt": saved, "losses": losses, "split_s": split,
                      "launches": {n: k.launches
                                   for n, k in kernels.items()}}),
          flush=True)


def remat_step(torch, registry, cfg, params, batch):
    """One loss and gradient at ``cfg`` (its ``remat`` as set): (loss,
    grads, seconds, peak bytes)."""
    from repro_torch.core.tree import tree_leaves
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, _ = registry.loss_fn(cfg, params, batch)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    torch.cuda.synchronize()
    return (loss.detach(), grads, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated())


# --------------------------------------------------------------------- mesh
def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def start_ranks(code, args, world, env):
    """``python -c code *args`` as ``world`` rank processes of one
    torch.distributed world on this host (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT`` in each one's environment, as
    torch.distributed.run sets them); returns the processes, in rank
    order, and the time they started (``wait_ranks`` collects them)."""
    port = free_port()
    procs = []
    for r in range(world):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, *args], cwd=ROOT,
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r),
                     WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                     MASTER_PORT=str(port)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs, time.perf_counter()


def wait_ranks(started, timeout=900):
    """The (exit code, stdout, stderr) of each process ``start_ranks``
    started, and the seconds from their start to the last one's end.
    Every process is ended before it returns."""
    procs, t0 = started
    try:
        deadline = time.monotonic() + timeout
        outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                for p in procs]
        return ([(p.returncode, *o) for p, o in zip(procs, outs)],
                time.perf_counter() - t0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def collective_probe_child(backend, out_path):
    """One rank of the backend probe: join a world of ``backend`` with
    every rank on ``cuda:0``, all_reduce and all_gather a CUDA tensor, and
    write what happened."""
    import torch
    import torch.distributed as dist
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.cuda.set_device(0)
    res = {"backend": backend}
    try:
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world)
        x = torch.full((1024,), float(rank + 1), device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        res["all_reduce"] = float(x[0]) == world * (world + 1) / 2
        parts = [torch.empty(1024, device="cuda") for _ in range(world)]
        dist.all_gather(parts, torch.full((1024,), float(rank), device="cuda"))
        torch.cuda.synchronize()
        res["all_gather"] = [float(p[0]) for p in parts] == list(
            map(float, range(world)))
        dist.destroy_process_group()
    except Exception as e:      # the probe records what the backend refused
        res["error"] = f"{type(e).__name__}: {str(e)[:300]}"
    if rank == 0:
        Path(out_path).write_text(json.dumps(res))


def collective_bytes(calls, rounds):
    """{"function@axis": bytes per round} over recorded calls."""
    out = {}
    for fn, axis, n in calls:
        out[f"{fn}@{axis}"] = out.get(f"{fn}@{axis}", 0) + n
    return {k: v / max(rounds, 1) for k, v in sorted(out.items())}


def probe_engine(base, calls):
    """``base`` (a FedRAC class) that records, for each dispatch block,
    the plane gathers it made along ``model`` (``launch.sharding``'s
    all_gather in ``calls``) beside the outputs a block gathers at its end
    (its plane, and its bank and history when it carries them); and that
    checks, wherever it unravels a tensor-parallel plane, each whole
    leaf's copies for equality across the chunks."""

    class Probe(base):
        def setup(self):
            self.probe = {"blocks": [], "rounds": 0, "replica_checks": 0,
                          "replica_mismatches": 0}
            return super().setup()

        def dispatch_rounds(self, level, members, plane, r0, n_rounds,
                            **kw):
            i = len(calls)
            out = super().dispatch_rounds(level, members, plane, r0,
                                          n_rounds, **kw)
            self.probe["rounds"] += n_rounds
            self.probe["blocks"].append({
                "level": level, "rounds": n_rounds,
                "outputs": (1 + (kw.get("bank") is not None)
                            + bool(kw.get("want_history"))),
                "plane_gathers": sum(
                    1 for f, a, _ in calls[i:]
                    if f == "sharding.all_gather" and a == "model")})
            return out

        def params_of(self, level, plane):
            spec = self.plane_spec(level)
            if self._tp and plane.dim() == 1:
                x = plane.reshape(spec.msize, spec.d_loc)
                self.probe["replica_checks"] += 1
                self.probe["replica_mismatches"] += sum(
                    1 for _, _, k, off, n in spec.recs if k is None
                    and not bool((x[:, off:off + n]
                                  == x[:1, off:off + n]).all()))
            return super().params_of(level, plane)

    return Probe


def launcher_sim_run(argv, shapes, nudge=0.0, probe=None):
    """``sim_run.main(argv)`` with run-to-run deterministic cuDNN and TF32
    off, ``sim_classes``' engine and simulator in place of the launcher's,
    and the (rows, columns) of every plane the fedagg route is given
    (``aggregation.aggregate_plane``) added to ``shapes``; ``nudge``
    scales every initial parameter by (1 + nudge).  With ``probe`` (a
    dict; in a rank process, whose collectives it wraps for good) the
    engine is ``probe_engine``'s and ``probe`` gets its record, the
    collective bytes per round and each level's chunk length.  Returns
    (report, simulator, fedagg launches in ``sim.run``, the launches its
    records imply)."""
    import torch
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import aggregation, server as srv
    from repro_torch.kernels.fedagg import ops as f_ops
    from repro_torch.launch import sim_run
    from repro_torch.obs import make_observability
    from repro_torch.core.tree import tree_map
    from repro_torch.launch.hlo_analysis import record_collectives
    ShapeFedRAC, CountingSim = sim_classes(srv, sim_run.HeterogeneitySim)
    kernel = f_ops.weighted_aggregate
    aggregate_plane = aggregation.aggregate_plane
    if probe is not None:
        calls = record_collectives()
        ShapeFedRAC = probe_engine(ShapeFedRAC, calls)

    class Engine(ShapeFedRAC):
        def init_params(self, level):
            p = super().init_params(level)
            return tree_map(lambda x: x * (1.0 + nudge), p) if nudge else p

    def recording(plane, weights):
        shapes.add(tuple(plane.shape))
        return aggregate_plane(plane, weights)

    class LauncherSim(CountingSim):
        def __init__(self, *a, obs=None, **kw):
            super().__init__(*a, obs=obs or make_observability(trace=False),
                             **kw)
            LauncherSim.last = self

        def run(self, test):
            kernel.launches = 0
            return super().run(test)

    saved = (srv.FedRAC, sim_run.HeterogeneitySim)
    srv.FedRAC, sim_run.HeterogeneitySim = Engine, LauncherSim
    aggregation.aggregate_plane = recording
    try:
        report = sim_run.main(argv)
    finally:
        srv.FedRAC, sim_run.HeterogeneitySim = saved
        aggregation.aggregate_plane = aggregate_plane
    sim = LauncherSim.last
    if probe is not None:
        fl = sim.fl
        probe.update(fl.probe, tp=fl._tp,
                     collectives=collective_bytes(calls, fl.probe["rounds"]),
                     chunk={str(l): fl.plane_spec(l).d_pad // fl._mesh_m
                            for l in sim.params})
    comp = int(sim.obs.registry.counter("agg/bank_compressions").value)
    return (report, sim, kernel.launches,
            expected_fedagg_launches(report.rows, sim.terminal, comp,
                                     sim.fl.cfg.aggregation == "buffered"))


def mesh_child(argv):
    """One rank of the mesh phase (its world in the environment): the
    launcher through ``launcher_sim_run`` with its probe; writes the
    rank's fedagg record, probe, peak memory and seconds, and final planes
    (in the unsharded layout, whatever the run's), beside
    ``--report-out``."""
    import numpy as np
    import torch
    from repro_torch.core.plane import make_plane_spec
    from repro_torch.kernels.distill import ops as d_ops
    from repro_torch.kernels.flash import ops as a_ops
    shapes, probe = set(), {}
    t0 = time.perf_counter()
    report, sim, launches, expected = launcher_sim_run(argv, shapes,
                                                       probe=probe)
    rank = int(os.environ["RANK"])
    out = argv[argv.index("--report-out") + 1]
    Path(f"{out}.rank{rank}.json").write_text(json.dumps(
        {"rank": rank, "launches": launches, "expected_launches": expected,
         "shapes": sorted(shapes), "probe": probe,
         "other_launches": {"distill": d_ops.kd_loss_rows.launches,
                            "flash": a_ops.flash_attention_bh.launches},
         "seconds": time.perf_counter() - t0,
         "peak_mem_bytes": torch.cuda.max_memory_allocated()}))
    np.savez(f"{out}.rank{rank}.planes.npz",
             **{str(l): make_plane_spec(p).to_plane(p).cpu().numpy()
                for l, p in sim.params.items()})


def report_parts(doc):
    """A report's rows split into the exact host part (every cluster field
    but the loss and accuracy) and, per record, each cluster's (loss,
    accuracy)."""
    host, vals = [], []
    for r in doc["rows"]:
        host.append({k: v for k, v in r.items() if k != "clusters"})
        host.extend({k: v for k, v in c.items()
                     if k not in ("mean_loss", "acc")}
                    for c in r["clusters"])
        vals.append([(c["mean_loss"], c["acc"]) for c in r["clusters"]])
    return host, vals


def accuracy_gap(vals, ref):
    """The largest accuracy difference between two reports' records."""
    return max((abs(a[1] - b[1]) for v, w in zip(vals, ref)
                for a, b in zip(v, w)
                if a[1] is not None and b[1] is not None), default=0.0)


def loss_shares(vals, ref):
    """Per record, the parity tolerance's share of the largest loss gap."""
    return [tolerance_share([c[0] for c in v], [c[0] for c in w])
            for v, w in zip(vals, ref)]


# ----------------------------------------------------------------- LM families
def prefill_vs_decode(torch, registry, encdec, moe, cfg, device, B, S, seed,
                      nudge=False):
    """Weights drawn on ``device`` from a seeded generator; the prefill
    forward of B x S random tokens (enc-dec: with S random frame
    embeddings, the cross cache built from them), then the same tokens one
    ``decode_step`` at a time.  Returns (summary, per-position gaps
    (B, S) relative to the largest |logit|, (B, S) mask of the positions
    at or after the first position whose MoE top-k choices differ between
    the two paths in any layer, and with ``nudge`` the prefill's own
    per-position response to a one-ulp fp32 nudge of the embedding table
    (relative 2**-24 times a normal draw), else None).

    A router's top-k is discrete: in bf16 a rounding difference between
    the prefill's scan and the decode's recurrence can move a token to
    another expert, and that token's logits (and, through the mixers'
    state, those after it) then differ by far more than rounding."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: 0)
    g = torch.Generator(device=device).manual_seed(seed)
    sync()
    t0 = time.perf_counter()
    params = registry.init_params(cfg, g)
    sync()
    out = {"init_seconds": time.perf_counter() - t0,
           "params": registry.param_count(params)}
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                         device=device)
    emb = (torch.randn(B, S, cfg.d_model, generator=g, device=device)
           if registry.is_encdec(cfg) else None)
    routes, route = [], moe._route

    def recording(p, c, x):
        probs, top_w, top_i = route(p, c, x)
        routes.append(top_i.reshape(B, -1, c.experts_per_tok).sort(-1)[0])
        return probs, top_w, top_i

    moe._route = recording
    try:
        with torch.no_grad():
            sync()
            t0 = time.perf_counter()
            if emb is None:
                full, _ = registry.forward(cfg, params, {"tokens": toks})
            else:
                full, _ = encdec.forward(cfg, params, toks, embeds=emb)
            sync()
            out["prefill_seconds"] = time.perf_counter() - t0
            pre = list(routes)
            routes.clear()
            response = None
            if nudge:
                e = params["embed"]
                params["embed"] = e * (1 + 2.0 ** -24 * torch.randn(
                    e.shape, generator=g, device=device, dtype=e.dtype))
                again, _ = registry.forward(cfg, params, {"tokens": toks})
                params["embed"] = e
                response = ((again.float() - full.float()).abs().amax(-1)
                            / full.float().abs().max()).cpu()
                del again
                routes.clear()
            t0 = time.perf_counter()
            cache = registry.init_cache(cfg, B, S, src_len=S, device=device)
            if emb is not None:
                cache = encdec.build_cross_cache(cfg, params, cache, emb)
            steps = []
            for t in range(S):
                lg, cache = registry.decode_step(cfg, params, cache,
                                                 toks[:, t:t + 1], t)
                steps.append(lg)
            dec = torch.cat(steps, dim=1)
            sync()
            out["decode_seconds_per_step"] = (time.perf_counter() - t0) / S
    finally:
        moe._route = route
    flipped = torch.zeros((B, S), dtype=torch.bool)
    flips = []
    for l, a in enumerate(pre):                      # MoE layers in order
        b = torch.cat(routes[l::len(pre)], dim=1)    # (B, S, K) by step
        f = (a != b).any(-1).cpu()
        flips.append(int(f.sum()))
        flipped |= f
    full, dec = full.float(), dec.float()
    scale = float(full.abs().max())
    gaps = ((dec - full).abs().amax(-1) / max(scale, 1e-30)).cpu()
    out.update(max_abs_gap=float((dec - full).abs().max()),
               max_abs_logit=scale, relative_gap=float(gaps.max()),
               finite=bool(torch.isfinite(full).all()
                           and torch.isfinite(dec).all()),
               router_flips_per_moe_layer=flips)
    del params, cache, full, dec, steps
    return out, gaps, flipped.cummax(dim=1)[0], response


def first_moe_kept(torch, cfg, params, toks):
    """(kept, made) routing choices of the first MoE block's capacity
    dispatch on ``toks``: the block's input is recomputed as the model
    computes it (norm, attention, residual, norm)."""
    from repro_torch.core.tree import tree_map
    from repro_torch.models import attention, moe, transformer
    from repro_torch.models.layers import apply_norm
    p = tree_map(lambda x: x[0], params["blocks"]["p0"])
    B, S = toks.shape
    h = transformer.embed_tokens(cfg, params, toks)
    pos = torch.arange(S, device=toks.device)[None].expand(B, S)
    h = h + attention.attn_forward(p["mixer"], cfg,
                                   apply_norm(cfg, p["norm1"], h), pos)
    return moe.kept_choices(p["ffn"], cfg, apply_norm(cfg, p["norm2"], h))


class LogLines(logging.Handler):
    """A logging handler that keeps each record's message."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def phase_train(torch, dev, env, zero_counts, read_counts):
    """Phase 18, ``train``: ``repro_torch.launch.train`` at full OLMo-1B
    width and depth as a process (``train_child``), then one step at its
    context with remat off and on, from the same weights.  Returns the
    launches (the process's and the two steps')."""
    from repro_torch.configs import get_config
    from repro_torch.core.scaling import param_count
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.synthetic import lm_batches, make_lm_corpus
    from repro_torch.launch import train as train_mod
    from repro_torch.models import registry
    train_dir = ROOT / "build" / "chip_smoke" / "train"
    shutil.rmtree(train_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    zero_counts()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", TRAIN_CHILD, *TRAIN_ARGS,
                           "--ckpt-dir", str(train_dir)],
                          capture_output=True, text=True, timeout=900,
                          env=env, cwd=ROOT)
    train_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"launch.train exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    out = proc.stdout.strip().splitlines()
    extra = json.loads(out[-1])
    tcfg = get_config("olmo-1b")
    batch_tokens = (int(TRAIN_ARGS[TRAIN_ARGS.index("--batch") + 1])
                    * int(TRAIN_ARGS[TRAIN_ARGS.index("--seq") + 1]))
    rates = [float(l.split("tok/s=")[1].replace(",", ""))
             for l in out if l.startswith("step ")]
    step_s = [batch_tokens / r for r in rates]
    n_params = int(param_count(tcfg))
    ck, losses = extra["ckpt"], extra["losses"]
    if not (out[0].startswith(f"arch={tcfg.name} params=")
            and "mesh={'data': 1, 'model': 1}" in out[0]
            and len(rates) == 20 and out[-2].startswith("final ce: ")
            and f"saved {ck['path']}" in out
            and all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"launch.train output: {out[:3]} ... "
                             f"{out[-3:]}")
    if not (ck["restored_equal"] and ck["dtypes"] == ["torch.bfloat16"]):
        raise AssertionError(f"the train checkpoint does not restore the "
                             f"trained bf16 leaves: {ck}")
    # one step at OLMo-1B's context, from the same weights, remat off/on
    params = train_mod.init_train_params(tcfg, 0, dev)
    n_drawn = sum(x.numel() for x in tree_leaves(params))
    if n_drawn != n_params:
        raise AssertionError(f"drew {n_drawn} parameters, the config has "
                             f"{n_params}")
    toks = lm_batches(make_lm_corpus(tcfg.vocab_size, 4 * REMAT_S, seed=0),
                      REMAT_B, REMAT_S, 1, seed=0)[0]
    batch = train_mod.lm_batch(tcfg, toks, dev)
    plain = remat_step(torch, registry, tcfg, params, batch)
    remat = remat_step(torch, registry, tcfg.replace(remat=True), params,
                       batch)
    loss_gap = abs(float(plain[0]) - float(remat[0]))
    grad_share = max(float((a.float() - b.float()).abs().max())
                     / max(float(a.float().abs().max()), 1e-30)
                     for a, b in zip(plain[1], remat[1]))
    remat_rec = {"batch": REMAT_B, "seq": REMAT_S,
                 "loss": {"off": float(plain[0]), "on": float(remat[0])},
                 "loss_gap": loss_gap, "grad_max_share": grad_share,
                 "tolerance": REMAT_TOL,
                 "seconds": {"off": plain[2], "on": remat[2]},
                 "peak_mem_bytes": {"off": plain[3], "on": remat[3]}}
    del params, plain, remat, batch
    torch.cuda.empty_cache()
    if not (loss_gap <= REMAT_TOL * abs(remat_rec["loss"]["off"])
            and grad_share <= REMAT_TOL):
        raise AssertionError(f"remat=True differs from remat=False: "
                             f"{remat_rec}")
    # the launcher's launches (its process) and the two steps' (here)
    launches = {k: v + extra["launches"][k]
                for k, v in read_counts().items()}
    if any(launches.values()):
        raise AssertionError(f"train launched {launches}")
    emit({"phase": "train", "argv": TRAIN_ARGS, "arch": tcfg.name,
          "layers": tcfg.n_layers, "d_model": tcfg.d_model,
          "params": n_params, "dtype": tcfg.dtype,
          "optimizer": "adamw, fp32 moments", "schedule": "wsd",
          "process_seconds": train_s,
          "tokens_per_second": len(step_s) * batch_tokens / sum(step_s),
          "median_step_s": sorted(step_s)[len(step_s) // 2],
          "first_step_s": step_s[0],
          "median_clip_s": sorted(extra["split_s"]["clip"])[
              len(step_s) // 2],
          "median_update_s": sorted(extra["split_s"]["update"])[
              len(step_s) // 2],
          "peak_mem_bytes": extra["peak_mem_bytes"],
          "ce_first": losses[0], "ce_last": losses[-1],
          "ckpt_bytes": ck["bytes"], "ckpt_seconds": ck["seconds"],
          "restored_equal": ck["restored_equal"],
          "stdout_head": out[:2], "stdout_tail": out[-3:-1],
          "remat": remat_rec, "launches": launches})
    return launches


def phase_lm_example(env):
    """Phase 19, ``lm_example``: ``examples/torch_fedrac_lm_train.py`` as a
    process at its defaults; it exits 0 with its assert (the loss fell)
    held."""
    ex_dir = ROOT / "build" / "chip_smoke" / "lm_example"
    shutil.rmtree(ex_dir, ignore_errors=True)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable,
                           str(ROOT / "examples" / "torch_fedrac_lm_train.py"),
                           "--ckpt-dir", str(ex_dir)],
                          capture_output=True, text=True, timeout=600,
                          env=env, cwd=ROOT)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"torch_fedrac_lm_train exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    out = proc.stdout.strip().splitlines()
    emit({"phase": "lm_example",
          "argv": ["--ckpt-dir", str(ex_dir.relative_to(ROOT))],
          "seconds": secs, "exit_code": proc.returncode,
          "first_line": out[0], "last_lines": out[-3:],
          "ckpt": sorted(p.name for p in ex_dir.iterdir())})


def tolerance_share(got, want):
    """The largest |got - want| / (atol + rtol |want|) over the elements
    (the parity tolerance's share; NaN pairs, a cluster with no live
    member in both runs, count as equal)."""
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    both_nan = np.isnan(got) & np.isnan(want)
    share = np.abs(got - want) / (PARITY_ATOL + PARITY_RTOL * np.abs(want))
    share = np.where(both_nan, 0.0, share)
    return float(np.nanmax(share, initial=0.0)) if not np.isnan(
        share).any() else float("inf")


def mesh_worlds(started, start_mesh, unsharded, mesh_dir):
    """The mesh phase's runs: the unsharded and nudged runs in this
    process while the probes, the one-rank mesh and the 1x2 tensor-parallel
    mesh (in ``started``) run; then, by what the gloo probe found, the
    two-rank and 2x2 meshes (with and without the tensor-parallel forward)
    together.  Returns (probes, {world name: (rank results, seconds)}, the
    unsharded run, the nudged run); ``started`` ends empty."""
    uns = unsharded("unsharded")
    nud = unsharded("nudged", 2.0 ** -23)
    probes, done = {}, {}
    for b in ("gloo", "nccl"):
        res, secs = wait_ranks(started.pop(b), timeout=180)
        path = mesh_dir / f"probe_{b}.json"
        probes[b] = (json.loads(path.read_text()) if path.exists()
                     else {"error": f"exit codes {[r[0] for r in res]}: "
                                    f"{res[0][2][-300:]}"})
        probes[b]["seconds"] = secs
    # the launcher picks gloo for two ranks on one card (launch.mesh.
    # default_backend): the probe says whether gloo carries them
    gloo = probes["gloo"]
    if gloo.get("all_reduce"):
        started["2"] = start_mesh("2")
        if gloo.get("all_gather"):
            started["2x2"] = start_mesh("2x2")
            started["2x2-tp"] = start_mesh("2x2-tp")
    for name in list(started):
        done[name] = wait_ranks(started.pop(name))
    return probes, done, uns, nud


def world_checks(torch, dev, name, res, secs, mesh_dir, uns, allowed):
    """One rank world of the mesh phase against the unsharded run: every
    record's host fields equal, each record's losses and each rank's final
    planes within the allowed tolerance shares, each rank's fedagg
    launches equal to its records' count; fedagg held against its plain
    version at every per-rank shape.  Returns (the world's record, its
    failures)."""
    from repro_torch.kernels.fedagg import ops as f_ops, ref as f_ref
    import numpy as np
    (uns_host, uns_vals), uns_planes, _ = uns
    shape, tp_fwd = MESH_WORLDS[name]
    n, m = (int(x) for x in (shape + "x1").split("x")[:2])
    out = mesh_dir / f"mesh_{name}.json"
    bad = [(r, rc, err[-1500:]) for r, (rc, _, err) in enumerate(res)
           if rc != 0]
    if bad:
        raise AssertionError(f"mesh {name}: ranks failed {bad}")
    backend = res[0][1].split("backend=")[1].split()[0]
    host, vals = report_parts(json.loads(out.read_text()))
    failures = []
    if host != uns_host:
        failures.append(f"mesh {name}: the records' host fields differ "
                        "from the unsharded run's")
    ranks = []
    for r in range(n * m):
        rec = json.loads(Path(f"{out}.rank{r}.json").read_text())
        planes = np.load(f"{out}.rank{r}.planes.npz")
        if rec["launches"] != rec["expected_launches"]:
            failures.append(f"mesh {name} rank {r}: fedagg "
                            f"{rec['launches']}, records imply "
                            f"{rec['expected_launches']}")
        ranks.append({"rank": r, "launches": rec["launches"],
                      "expected_launches": rec["expected_launches"],
                      "other_launches": rec["other_launches"],
                      "fedagg_shapes": rec["shapes"],
                      "seconds": rec["seconds"],
                      "peak_mem_bytes": rec["peak_mem_bytes"],
                      "probe": rec["probe"],
                      "plane_share": max(
                          tolerance_share(planes[l][:len(w)], w)
                          for l, w in uns_planes.items())})
    by_round = loss_shares(vals, uns_vals)
    over = [r for r, (x, a) in enumerate(zip(
        by_round, allowed["loss_by_round"])) if x > a]
    if over or max(rk["plane_share"] for rk in ranks) > allowed["plane"]:
        failures.append(f"mesh {name}: loss shares {by_round}, plane "
                        f"shares {[rk['plane_share'] for rk in ranks]}; "
                        f"allowed {allowed}")
    shapes = sorted({tuple(x) for rk in ranks for x in rk["fedagg_shapes"]})
    return {"mesh_shape": shape, "ranks": n * m, "backend": backend,
            "member_forward": ("tp" if tp_fwd else
                               "gather" if m > 1 else "replicated"),
            "process_seconds": secs, "loss_share_by_round": by_round,
            "max_accuracy_gap": accuracy_gap(vals, uns_vals),
            "per_rank": ranks,
            "fedagg_shapes_max_abs_err": {
                f"{C}x{D}": check_fedagg(torch, f_ops, f_ref, dev, C, D)[2]
                for C, D in shapes}}, failures


def phase_mesh(torch, dev, env, n_test, zero_counts):
    """Phase 20, ``mesh``: which backend carries CUDA tensors between two
    ranks on this card; then ``sim_run`` on sim_main's configuration
    unsharded (in process; once more with every initial parameter nudged
    by one fp32 ulp, the run's own response to rounding) and on meshes of
    ranks (one process each, as ``mesh_child``): one rank, two ranks on
    the 1D mesh where a backend allows them, and ``2x2 --no-tp-forward``
    where its all_gather works too; beside them, for the tp phase, 1x2
    and 2x2 with the tensor-parallel member forward.  Every record's host
    fields equal the unsharded run's; each record's losses and each rank's
    final planes within the parity tolerance, or within MESH_NUDGE_FACTOR
    times what the nudge moved them where the run's own conditioning
    exceeds it (a rank trains C/n members, and cuBLAS and cuDNN round
    another batch shape otherwise); each rank's fedagg launches equal to
    its records' count; fedagg held against its plain version at every
    per-rank shape (``world_checks``).  The rank worlds share the card
    with each other and with the in-process runs (``mesh_worlds``), so
    their seconds overlap.  Returns (the unsharded run's fedagg launches,
    {world: launches of each rank}, what the tp phase reads: the
    tensor-parallel worlds' records and failures, the gather 2x2 world's
    record, the nudge response and the allowed shares)."""
    mesh_dir = ROOT / "build" / "chip_smoke" / "mesh"
    shutil.rmtree(mesh_dir, ignore_errors=True)
    mesh_dir.mkdir(parents=True)

    def start_mesh(name):
        shape, tp_fwd = MESH_WORLDS[name]
        n, m = (int(x) for x in (shape + "x1").split("x")[:2])
        out = mesh_dir / f"mesh_{name}.json"
        argv = MESH_ARGS + ["--mesh-shape", shape, "--report-out", str(out)]
        if m > 1 and not tp_fwd:
            argv.append("--no-tp-forward")
        return start_ranks(MESH_CHILD, argv, n * m, env)

    def unsharded(name, nudge=0.0):
        shapes = set()
        out = mesh_dir / f"{name}.json"
        zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            _, sim, launches, expected = launcher_sim_run(
                MESH_ARGS + ["--report-out", str(out)], shapes, nudge=nudge)
        secs = time.perf_counter() - t0
        torch.backends.cudnn.deterministic = False
        if launches != expected:
            raise AssertionError(f"{name} launcher: fedagg {launches}, "
                                 f"records imply {expected}")
        planes = {str(l): sim.fl.plane_of(l, p).cpu().numpy()
                  for l, p in sim.params.items()}
        return (report_parts(json.loads(out.read_text())), planes,
                {"seconds": secs, "launches": launches,
                 "expected_launches": expected,
                 "fedagg_shapes": sorted(shapes)})

    # the worlds share the card: the probes and the one-rank mesh start
    # together, beside the unsharded runs in this process, then the
    # multi-rank meshes together; their seconds overlap
    started = {}
    try:
        for b in ("gloo", "nccl"):
            started[b] = start_ranks(
                PROBE_CHILD, [b, str(mesh_dir / f"probe_{b}.json")], 2, env)
        started["1"] = start_mesh("1")
        started["1x2-tp"] = start_mesh("1x2-tp")
        probes, done, uns, nud = mesh_worlds(started, start_mesh, unsharded,
                                             mesh_dir)
    finally:
        for procs, _ in started.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    (uns_host, uns_vals), uns_planes, uns_rec = uns
    (nud_host, nud_vals), nud_planes, _ = nud

    nudge = {"host_equal": nud_host == uns_host,
             "max_accuracy_gap": accuracy_gap(nud_vals, uns_vals),
             "loss_share_by_round": loss_shares(nud_vals, uns_vals),
             "plane_share": max(tolerance_share(nud_planes[l], w)
                                for l, w in uns_planes.items())}
    # each record may move as far as MESH_NUDGE_FACTOR times the nudge
    # moved it, and always as far as the parity tolerance
    allowed = {"loss_by_round": [max(1.0, MESH_NUDGE_FACTOR * x)
                                 for x in nudge["loss_share_by_round"]],
               "plane": max(1.0, MESH_NUDGE_FACTOR * nudge["plane_share"])}
    runs, tp_runs, failures, tp_failures = {}, {}, [], []
    for name, (res, secs) in done.items():
        rec, bad = world_checks(torch, dev, name, res, secs, mesh_dir, uns,
                                allowed)
        if MESH_WORLDS[name][1]:
            tp_runs[name], tp_failures = rec, tp_failures + bad
        else:
            runs[name], failures = rec, failures + bad
    emit({"phase": "mesh", "argv": MESH_ARGS, "backend_probe": probes,
          "one_rank_only": len(runs) == 1,
          "concurrent": "the probes and the one-rank and 1x2 tensor-"
                        "parallel meshes beside the unsharded runs, then "
                        "the other multi-rank meshes together: seconds "
                        "overlap",
          "unsharded": uns_rec, "nudge_response": nudge,
          "allowed_shares": allowed,
          "runs": {k: {kk: vv for kk, vv in v.items() if kk != "per_rank"}
                   | {"per_rank": [{kk: vv for kk, vv in rk.items()
                                    if kk != "probe"}
                                   for rk in v["per_rank"]]}
                   for k, v in runs.items()},
          "collectives_per_round": {k: [rk["probe"]["collectives"]
                                        for rk in v["per_rank"]]
                                    for k, v in runs.items()},
          "tolerance": {"rtol": PARITY_RTOL, "atol": PARITY_ATOL,
                        "nudge_factor": MESH_NUDGE_FACTOR}})
    if failures or not nudge["host_equal"]:
        raise AssertionError(f"mesh: {failures}; nudge {nudge}")
    return (uns_rec["launches"],
            {k: [rk["launches"] for rk in v["per_rank"]]
             for k, v in runs.items()},
            {"runs": tp_runs, "failures": tp_failures,
             "gather": runs.get("2x2"), "nudge": nudge, "allowed": allowed})


def tp_lm_child(argv):
    """One rank of a tp or tp_families phase LM world (``RANK`` and
    ``WORLD_SIZE`` in its environment; every rank on ``cuda:0``, over
    gloo): lm_main's federation on the configuration ``argv[3]``
    (``LM_MODELS``) at ``argv[2]`` participants on a 1x2 mesh with the
    tensor-parallel member forward (``argv[1]`` "tp") or the gather path
    ("gather"), ``train()`` once with the kernel counts set to 0 before
    it; writes ``rank<r>.json`` under ``argv[0]``: the per-round member
    losses, the launches and what the code implies, fedagg's shapes, the
    query heads each flash launch took, the probe, the collective bytes
    per round, peak memory and seconds.  An MoE configuration also
    records, before training, each router's top-k on the master's first
    member batch under the TP forward against the unsharded forward of
    the same parameters in this process (``routing_flips``)."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core import aggregation, server as srv
    from repro_torch.kernels.distill import ops as d_ops
    from repro_torch.kernels.fedagg import ops as f_ops
    from repro_torch.kernels.flash import ops as a_ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.hlo_analysis import record_collectives
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.cuda.set_device(0)
    mesh_lib.init_world(rank, world, "env://", "gloo")
    mesh = mesh_lib.make_sim_mesh(f"1x{world}", device_type="cuda")
    calls = record_collectives()
    shapes, heads = set(), {}
    aggregate_plane, flash_bh = (aggregation.aggregate_plane,
                                 a_ops.flash_attention_bh)

    def recording(plane, weights):
        shapes.add(tuple(plane.shape))
        return aggregate_plane(plane, weights)

    def flash(q, k, v, **kw):
        heads[kw["heads"]] = heads.get(kw["heads"], 0) + 1
        return flash_bh(q, k, v, **kw)

    # the kernel's own count reads its module's name, so the wrapper
    # carries it
    flash.launches = 0
    aggregation.aggregate_plane, a_ops.flash_attention_bh = recording, flash
    t0 = time.perf_counter()
    srv.FedRAC = probe_engine(srv.FedRAC, calls)
    mode, participants, model = argv[1], int(argv[2]), argv[3]
    base, cfg, lm, ltest, _ = lm_main_engine(
        srv, torch, "cuda", mesh=mesh, participants=participants,
        tp_forward=mode == "tp", model=model)
    live = [l for l in range(lm.m) if lm.assignment.members.get(l)]
    flips = (routing_flips(torch, lm, base, torch.as_tensor(
        ltest["tokens"][:LM_FL["local_batch"]], device="cuda"))
             if base.n_experts and mode == "tp" else None)
    f_ops.weighted_aggregate.launches = d_ops.kd_loss_rows.launches = 0
    flash.launches = 0
    heads.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    lm.train(ltest)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t1
    R, steps = cfg.rounds, cfg.steps_per_round
    # attention layers (each launches flash once a forward)
    L = base.n_superblocks * sum(k.startswith("attn")
                                 for k in base.block_pattern)
    H = base.n_heads
    # the member steps and a slave's teacher forward take the rank's local
    # heads under the TP forward; the evaluation, outside the block, every
    # head
    steps_heads = sum(R * L * (steps + (1 if l > 0 else 0)) for l in live)
    by_heads = ({str(H // world): steps_heads, str(H): R * L * len(live)}
                if mode == "tp" else {str(H): steps_heads + R * L * len(live)})
    by_heads = {h: n for h, n in by_heads.items() if n}
    Path(argv[0], f"rank{rank}.json").write_text(json.dumps({
        "rank": rank, "mode": mode, "participants": participants,
        "model": model, "tp": lm._tp, "block_losses": lm.block_losses,
        "routing_flips": flips,
        "launches": {"fedagg": f_ops.weighted_aggregate.launches,
                     "distill": d_ops.kd_loss_rows.launches,
                     "flash": flash.launches},
        # per dispatched round of a cluster: one launch per layer for each
        # member step, one for a slave's teacher forward, one for the
        # round's evaluation (lm_main's formula without its KD report)
        "expected_launches": {
            "fedagg": R * len(live), "distill": 0,
            "flash": sum(R * L * (steps + 1 + (1 if l > 0 else 0))
                         for l in live)},
        "fedagg_shapes": sorted(shapes),
        "flash_launches_by_heads": {str(h): n for h, n in heads.items()},
        "expected_flash_launches_by_heads": by_heads,
        # a TP plane's chunk length (the gather path has no chunks)
        "chunk": ({str(l): lm.plane_spec(l).d_loc for l in live}
                  if lm._tp else None),
        "probe": lm.probe,
        "collectives": collective_bytes(calls, lm.probe["rounds"]),
        "train_seconds": train_s,
        "process_seconds": time.perf_counter() - t0,
        "peak_mem_bytes": torch.cuda.max_memory_allocated()}))
    torch.distributed.destroy_process_group()


def routing_flips(torch, lm, base, tokens):
    """Each router's top-k on ``tokens`` under the TP forward of the
    master's initial parameters against the unsharded forward of the same
    parameters, in this rank: the choices made, how many tokens' expert
    sets differ, the largest gap between the k-th and (k+1)-th router
    probability at such a token (a near-tie when below ``TP_NEAR_TIE``)
    and the smallest gap anywhere."""
    from repro_torch.models import moe, tp, transformer
    calls, orig = {"whole": [], "tp": []}, moe.top_k
    where = ["whole"]

    def rec(probs, k):
        vals, idx = orig(probs, k)
        srt = torch.sort(probs, dim=-1, descending=True).values
        calls[where[0]].append((torch.sort(idx, dim=-1).values,
                                srt[..., k - 1] - srt[..., k]))
        return vals, idx

    plane = lm.plane_of(0, lm.init_params(0))
    spec = lm.plane_spec(0)
    moe.top_k = rec
    try:
        with torch.no_grad():
            transformer.forward(base, lm.params_of(0, plane), tokens)
            with tp.tp_shard_ctx(lm.mesh, lm.model_axis):
                where[0] = "tp"
                chunk = plane.reshape(spec.msize, spec.d_loc)[tp.tp_rank()]
                transformer.forward(base, spec.local_params(chunk), tokens)
    finally:
        moe.top_k = orig
    if len(calls["whole"]) != len(calls["tp"]):
        raise AssertionError(f"routers: {len(calls['whole'])} unsharded, "
                             f"{len(calls['tp'])} under TP")
    flips, gaps_at_flips, min_gap, made = 0, [0.0], float("inf"), 0
    for (wi, gap), (ti, _) in zip(calls["whole"], calls["tp"]):
        differ = (wi != ti).any(dim=-1)
        flips += int(differ.sum())
        made += differ.numel()
        if bool(differ.any()):
            gaps_at_flips.append(float(gap[differ].max()))
        min_gap = min(min_gap, float(gap.min()))
    return {"routers": len(calls["tp"]), "tokens": made, "flips": flips,
            "max_gap_at_flip": max(gaps_at_flips), "min_gap": min_gap,
            "near_tie": TP_NEAR_TIE}


def tp_module_child(argv):
    """One rank of the tp_families phase's module world (every rank on
    ``cuda:0``, over gloo, a 1x``WORLD_SIZE`` mesh): jamba's Mamba mixer
    and MoE FFN, and xlstm-350m's mLSTM (the federation's chunkwise
    route) and sLSTM blocks, at full width in fp32, parameters drawn on
    the card from a
    seeded generator (the same on every rank), ``TP_MODULE_MEMBERS``
    members of ``TP_MODULE_TOKENS`` tokens each.  The ranks take turns to
    run the unsharded module (its forward, and its per-member gradients
    under ``vmap(grad)``), each keeping its chunk of the result and its
    slice of the parameters; then all run the module tensor-parallel and
    hold forward and gradients against what they kept.  The mLSTM block
    runs again on ``TP_MLSTM_SEEDS``, and each of its unsharded forwards
    once more on the host.  Then ``tp_bf16_member``.  Writes
    ``rank<r>.json`` under ``argv[0]``: per module the worst share of the
    tolerance and the largest difference, seconds, peak memory and the
    collective bytes of one tensor-parallel forward and backward, and the
    bf16 member step's readings."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib, sharding
    from repro_torch.launch.hlo_analysis import record_collectives
    from repro_torch.models import mamba, moe, tp, xlstm_blocks as xb
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.cuda.set_device(0)
    mesh_lib.init_world(rank, world, "env://", "gloo")
    mesh = mesh_lib.make_sim_mesh(f"1x{world}", device_type="cuda")
    calls = record_collectives()
    jcfg = get_config(TP_MODULE_ARCH).replace(dtype="float32")
    xcfg = get_config(TP_XLSTM_ARCH).replace(**LM_MODELS["xlstm"][1])
    C, (B, S) = TP_MODULE_MEMBERS, TP_MODULE_TOKENS
    modules = {
        "mamba": (jcfg, mamba.init_mamba, lambda cfg, p, x: (
            mamba.mamba_forward(p, cfg, x), 0.0)),
        "moe": (jcfg, moe.init_moe, lambda cfg, p, x: moe.apply_moe(
            p, cfg, x)),
        "mlstm": (xcfg, xb.init_mlstm, lambda cfg, p, x: (
            xb.mlstm_forward(p, cfg, x), 0.0)),
        "slstm": (xcfg, xb.init_slstm, lambda cfg, p, x: (
            xb.slstm_forward(p, cfg, x), 0.0))}
    runs = [(seed, name, *m) for seed, (name, m) in enumerate(modules.items())]
    runs += [(seed, f"mlstm_seed{seed}", *modules["mlstm"])
             for seed in TP_MLSTM_SEEDS]
    out = {"rank": rank, "members": C, "tokens": [B, S], "modules": {}}
    for seed, name, cfg, init, fwd in runs:
        fn = functools.partial(fwd, cfg)
        g = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn(C, B, S, cfg.d_model, device="cuda", generator=g)
        cot = torch.randn(C, B, S, cfg.d_model, device="cuda", generator=g)

        def loss(p, x, cot):
            y, aux = fn(p, x)
            return (y * cot).mean() + cfg.router_aux_coef * aux

        def run(p):
            y = torch.func.vmap(lambda x: fn(p, x)[0])(x)
            gr = torch.func.vmap(torch.func.grad(loss),
                                 in_dims=(None, 0, 0))(p, x, cot)
            torch.cuda.synchronize()
            return y, gr

        rec = {}
        for turn in range(world):
            if turn == rank:
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                p = init(torch.Generator(device="cuda").manual_seed(
                    100 + seed), cfg, torch.float32)
                specs = sharding.tp_specs(cfg, p, world, "model")
                y_ref, g_ref = run(p)
                rec["unsharded_seconds"] = time.perf_counter() - t0
                if name.startswith("mlstm"):
                    # the unsharded module again in fp32 on the host: the
                    # share its summation order alone gives
                    p_host = {k: v.cpu() for k, v in p.items()}
                    rec["card_vs_host_forward"] = tensor_share(
                        torch, y_ref, torch.func.vmap(
                            lambda x: fn(p_host, x)[0])(x.cpu()))
                    del p_host
                # this rank's chunk of the member gradients (member dim
                # first), kept in host memory while the TP run holds the card
                g_ref = {k: sharding.local_block(
                    mesh, v, {a: d + 1 for a, d in specs[k].items()}).cpu()
                    for k, v in g_ref.items()}
                p = {k: sharding.local_block(mesh, v, specs[k]).clone()
                     for k, v in p.items()}
                rec["unsharded_peak_mem_bytes"] = \
                    torch.cuda.max_memory_allocated()
                rec["split"] = {k: v.get("model") for k, v in specs.items()}
                torch.cuda.empty_cache()
            dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        i = len(calls)
        t0 = time.perf_counter()
        with tp.tp_shard_ctx(mesh, "model"):
            y, gr = run(p)
        rec["tp_seconds"] = time.perf_counter() - t0
        rec["tp_peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        rec["collectives"] = collective_bytes(calls[i:], 1)
        rec["forward"] = tensor_share(torch, y, y_ref)
        rec["grads"] = {k: tensor_share(torch, gr[k], g_ref[k]) for k in gr}
        out["modules"][name] = rec
        del p, y, gr, y_ref, g_ref, x, cot
        torch.cuda.empty_cache()
    out["bf16_member"] = tp_bf16_member(torch, mesh, world, rank)
    Path(argv[0], f"rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()


def tp_bf16_member(torch, mesh, world, rank):
    """The TP plane's dtype rule (C8) on the card: ``TP_BF16_MODEL`` from
    a bf16 template, its TP plane built for ``world`` ranks.  This rank's
    chunk gives bf16 local leaves; one member step (``make_cluster_update``,
    one SGD step per member) under the TP forward sees and returns bf16
    leaves.  Its per-member gradients are held to the unsharded model's
    in bf16 leaves (the whole plane's ``to_params``), each leaf by its
    relative L2 difference, beside both runs' difference from the same
    parameters in fp32 (an fp32 configuration): the share of bf16's own
    rounding the split adds.  Returns the dtypes, the per-leaf readings,
    the step's losses and seconds."""
    from repro_torch.configs import get_config
    from repro_torch.core.client import make_cluster_update
    from repro_torch.core.families import lm_family
    from repro_torch.core.plane import make_tp_plane_spec
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.models import tp
    arch, cut = TP_BF16_MODEL
    C, (B, S) = TP_MODULE_MEMBERS, TP_MODULE_TOKENS
    fams = {dt: lm_family(get_config(arch).replace(dtype=dt, **cut), 0.5)
            for dt in ("bfloat16", "float32")}
    fam = fams["bfloat16"]
    t0 = time.perf_counter()
    p = fam.init(torch.Generator(device="cuda").manual_seed(300), 0)
    spec = make_tp_plane_spec(p, fam.param_specs(0, p, world, "model"),
                              msize=world)
    plane = spec.to_plane(p)
    del p
    tokens = torch.randint(0, get_config(arch).vocab_size, (C, B, S),
                           device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(301))
    seen = set()

    def loss_and_logits(dt, q, batch):
        seen.update(str(x.dtype) for x in tree_leaves(q))
        return fams[dt].loss_and_logits(0, q, batch)

    def grads(dt, params):
        def loss(q, t):
            return loss_and_logits(dt, q, {"tokens": t})[0]
        return torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0))(
            params, tokens)

    def whole_chunk(gr):
        """(C, ...) whole gradients -> this rank's (C, d_loc) chunk."""
        return spec.to_plane(gr).reshape(C, world, spec.d_loc)[:, rank]

    whole = spec.to_params(plane)
    dtypes = {"whole": sorted({str(x.dtype) for x in tree_leaves(whole)})}
    seen.clear()
    ref16 = whole_chunk(grads("bfloat16", whole))
    dtypes["unsharded_step"] = sorted(seen)
    ref32 = whole_chunk(grads("float32",
                              tree_map(lambda x: x.float(), whole)))
    del whole
    local = spec.local_params(plane.reshape(world, spec.d_loc)[rank])
    dtypes["local"] = sorted({str(x.dtype) for x in tree_leaves(local)})
    step = make_cluster_update(
        functools.partial(loss_and_logits, "bfloat16"), 1e-3)
    seen.clear()
    with tp.tp_shard_ctx(mesh, "model"):
        g_tp = spec.local_to_chunk(grads("bfloat16", local))
        new, losses = step(tree_map(lambda x: x.expand(C, *x.shape), local),
                           {"tokens": tokens[:, None]},
                           torch.ones(C, 1, device="cuda"))
    torch.cuda.synchronize()
    dtypes["tp_step"] = sorted(seen)
    dtypes["tp_trained"] = sorted({str(x.dtype) for x in tree_leaves(new)})
    leaves = []
    for shape, _, k, off, size in spec.recs:
        a, b, t = (x[:, off:off + size] for x in (g_tp, ref16, ref32))
        n = float(t.norm())
        leaves.append({"shape": list(shape), "split": k,
                       "tp_vs_bf16": float((a - b).norm()) / n,
                       "bf16_vs_fp32": float((b - t).norm()) / n,
                       "tp_vs_fp32": float((a - t).norm()) / n})
    return {"arch": arch, "cut": cut, "dtypes": dtypes, "leaves": leaves,
            "losses": losses.tolist(),
            "finite": bool(torch.isfinite(losses).all()
                           and all(bool(torch.isfinite(x).all())
                                   for x in tree_leaves(new))),
            "seconds": time.perf_counter() - t0}


def dryrun_programs(which, mesh):
    """The dryrun phase's program ``which`` ("train" or "fl") as
    ``launch.dryrun`` lowers it, and the vocabulary of its tokens."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import dryrun
    if which == "train":
        arch, B, S = DRYRUN_TRAIN
        cfg = get_config(arch)
        low, _ = dryrun.lower_one(cfg, InputShape("card", S, B, "train"),
                                  mesh)
        return low, cfg.vocab_size
    kw = {k: v for k, v in DRYRUN_FL.items() if k not in ("arch", "mesh")}
    low, fcfg = dryrun.lower_fl_round(get_config(DRYRUN_FL["arch"]), mesh,
                                      **kw)
    return low, fcfg.vocab_size


def dryrun_real(torch, low, vocab, keep=None):
    """Run a lowered program for real on the card: its collective record,
    the FLOPs ``FlopCounterMode`` counts, and its peak (bytes allocated
    above what the process held before the inputs were drawn, the peak
    counted from when they were in place); and ``keep(out)`` of its
    outputs (None without ``keep``)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch.hlo_analysis import record_collectives as rec
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    args = low.materialize("cuda", seed=0, vocab=vocab)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with rec() as calls, FlopCounterMode(display=False) as fc:
        out = low.fn(*args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    last = out[-1] if isinstance(out, tuple) else out
    finite = bool(all(torch.isfinite(x).all() for x in (
        tree_leaves_any(last))))
    res = {"collectives": [list(c) for c in calls],
           "flops": int(fc.get_total_flops()), "peak_bytes": peak,
           "seconds": secs, "finite_loss": finite}
    kept = keep(out) if keep else None
    del args, out, last
    torch.cuda.empty_cache()
    return res, kept


def tree_leaves_any(x):
    """The tensors of a tensor or a pytree of them."""
    from repro_torch.core.tree import tree_leaves
    return [x] if hasattr(x, "shape") else tree_leaves(x)


def dryrun_world_program(name, mesh, pos=None):
    """One program of ``DRYRUN_WORLD`` as ``launch.dryrun`` lowers it
    for ``mesh`` (None: the one-device program), a decode at ``pos``
    (``lower_one``'s default: rank 0's slice holds it): (Lowered,
    vocabulary of its tokens, the decode's position or None)."""
    import torch
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import dryrun, sharding, specs
    from repro_torch.models import mamba, tp
    _, arch, cache, B, S = [p for p in DRYRUN_WORLD if p[0] == name][0]
    cfg = get_config(arch)
    if name.startswith("g_"):
        cfg = cfg.replace(shard_mode="fsdp")
        return (dryrun.lower_one(cfg, InputShape("card", S, B, "train"),
                                 mesh)[0], cfg.vocab_size, None)
    cfg = cfg.replace(dtype="float32", cache_shard=cache)
    if not name.startswith("f_"):
        low, meta = dryrun.lower_one(cfg, InputShape("card", S, B, "decode"),
                                     mesh, pos=pos)
        return low, cfg.vocab_size, meta["pos"]
    # the Mamba mixer alone: its leaves, its cache with a stack of one in
    # front (``cache_specs``' layout), x (B, 1, d)
    p = specs._eval_shape(lambda: mamba.init_mamba(
        torch.Generator().manual_seed(0), cfg, torch.float32))
    c = specs._eval_shape(lambda: {k: v[None] for k, v in
                                   mamba.init_mamba_cache(
                                       cfg, B, torch.float32).items()})
    x = specs.meta((B, 1, cfg.d_model), torch.float32)
    if mesh is None:
        p_spec, c_spec = dryrun._replicated(p), dryrun._replicated(c)
    else:
        p_spec = sharding.param_specs(cfg, p, mesh)
        c_spec = sharding.cache_specs(cfg, c, mesh, shard_seq=False)

    def step(p, c, x):
        ctx = (tp.tp_shard_ctx(mesh, "model") if mesh is not None
               else contextlib.nullcontext())
        with torch.no_grad(), ctx:
            y, new = mamba.mamba_decode(p, cfg, {k: v[0] for k, v in
                                                 c.items()}, x, 0)
        return y, {k: v[None] for k, v in new.items()}

    return (dryrun.Lowered(step, (p, c, x), (p_spec, c_spec,
                                            dryrun._replicated(x)), mesh),
            cfg.vocab_size, None)


def block_share(torch, got, want):
    """``tensor_share`` of a tensor on the card against one in host
    memory, a chunk of its leading dim (about 2^26 elements) at a
    time."""
    if got.dim() == 0:
        got, want = got[None], want[None]
    step = max(1, got.shape[0] * (1 << 26) // max(got.numel(), 1))
    share = diff = 0.0
    for i in range(0, got.shape[0], step):
        g = got[i:i + step]
        w = want[i:i + step].to(g.device)
        d = (g - w).abs()
        share = max(share, float((d / (PARITY_ATOL
                                       + PARITY_RTOL * w.abs())).max()))
        diff = max(diff, float(d.max()))
    return {"share": share, "max_abs_diff": diff}


def dryrun_world_blocks(name, low, out):
    """[(output tensor, its spec)] of a program's outputs that the rank's
    are held to (the one-device outputs' blocks by these specs)."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import dryrun, sharding
    from repro_torch.launch.sharding import P
    if name.startswith("g_"):
        p_spec, o_spec = low.arg_specs[0], low.arg_specs[1]
        return (list(zip(tree_leaves(out[0]), dryrun._spec_leaves(p_spec)))
                + list(zip(tree_leaves(out[1]["m"]),
                           dryrun._spec_leaves(o_spec["m"])))
                + [(out[2], P())])
    c_specs = dryrun._spec_leaves(low.arg_specs[1])
    if name.startswith("f_"):
        first = P(None, None, None)
    else:
        # the logits' vocabulary splits where the embedding's rows do
        split = "model" in sharding._entry_axes(low.arg_specs[0]["embed"][0])
        first = P(c_specs[0][1], None, "model" if split else None)
    return [(out[0], first)] + list(zip(tree_leaves(out[1]), c_specs))


def dryrun_world_child(argv):
    """One rank of the dryrun phase's second world (every rank on
    ``cuda:0``, over gloo, a 1x2 mesh): each program of ``DRYRUN_WORLD``
    in turn.  The ranks take turns to run the one-device program, each
    keeping its blocks of the outputs in host memory; then both run the
    rank program for real (``dryrun_real``) and hold its outputs against
    what they kept.  Writes ``rank<r>.json`` under ``argv[0]``: per
    program the real run's record, FLOPs, peak and seconds, the largest
    share of the tolerance (or relative difference) and the launches of
    the three kernels (none: the analysis reaches no kernel)."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels.distill import ops as d_ops
    from repro_torch.kernels.fedagg import ops as f_ops
    from repro_torch.kernels.flash import ops as a_ops
    from repro_torch.launch import mesh as mesh_lib, sharding
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.cuda.set_device(0)
    mesh_lib.init_world(rank, world, "env://", "gloo")
    mesh = mesh_lib.make_host_mesh(1, world, device_type="cuda")
    f_ops.weighted_aggregate.launches = 0
    d_ops.kd_loss_rows.launches = 0
    a_ops.flash_attention_bh.launches = 0
    out = {"rank": rank, "programs": {}}
    for name, *_ in DRYRUN_WORLD:
        low, vocab, pos = dryrun_world_program(name, mesh)
        kept = None
        for turn in range(world):
            if turn == rank:
                one = dryrun_world_program(name, None, pos)[0]
                args = one.materialize("cuda", seed=0, vocab=vocab)
                want = one.fn(*args)
                kept = [sharding.local_block(mesh, w, sharding.spec_dims(
                    s)).detach().cpu() for (w, _), (_, s) in zip(
                        dryrun_world_blocks(name, one, want),
                        dryrun_world_blocks(name, low, want))]
                del one, args, want
                torch.cuda.empty_cache()
            dist.barrier()
        res, got = dryrun_real(torch, low, vocab, keep=lambda o: [
            g for g, _ in dryrun_world_blocks(name, low, o)])
        if name.startswith("g_"):
            rel = [float((g.float() - w.to(g.device).float()).norm()
                         / w.float().norm().clamp_min(1e-30))
                   for g, w in zip(got, kept)]
            res["worst_rel"] = max(rel)
            res["ce_rel"] = rel[-1]
            res["ce"] = [float(got[-1]), float(kept[-1])]
        else:
            shares = [block_share(torch, g, w) for g, w in zip(got, kept)]
            res["worst_share"] = max(x["share"] for x in shares)
            res["max_abs_diff"] = max(x["max_abs_diff"] for x in shares)
        del got, kept, low
        torch.cuda.empty_cache()
        out["programs"][name] = res
        dist.barrier()
    out["launches"] = {"fedagg": f_ops.weighted_aggregate.launches,
                       "distill": d_ops.kd_loss_rows.launches,
                       "flash": a_ops.flash_attention_bh.launches}
    Path(argv[0], f"rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()


def dryrun_fl_child(argv):
    """One rank of the dryrun phase's FL world (every rank on ``cuda:0``,
    over gloo, mesh ``DRYRUN_FL["mesh"]``): the FL round run for real.
    Writes ``rank<r>.json`` under ``argv[0]``."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.launch import mesh as mesh_lib
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.cuda.set_device(0)
    mesh_lib.init_world(rank, world, "env://", "gloo")
    mesh = mesh_lib.make_host_mesh(*DRYRUN_FL["mesh"], device_type="cuda")
    low, vocab = dryrun_programs("fl", mesh)
    res = dict(dryrun_real(torch, low, vocab)[0], rank=rank)
    Path(argv[0], f"rank{rank}.json").write_text(json.dumps(res))
    torch.distributed.destroy_process_group()


def phase_dryrun(torch, env):
    """Phase 23, ``dryrun``: ``launch.dryrun``'s programs analysed on fake
    tensors (a fake world of the mesh's size, as ``python -m
    repro_torch.launch.dryrun`` runs them) and run for real on the card:
    (a) OLMo-1B's training step on one card, (b) granite-moe's FL round
    on a 2x1 world of ``dryrun_fl_child`` ranks.  The collective record of
    each real rank equals the fake rank's call for call (op, axis,
    bytes), the FLOPs counted on the real run equal the fake count, and
    the real peak lies within ``DRYRUN_BAND`` of the predicted argument +
    temporary bytes.  Then ``DRYRUN_WORLD``'s programs on a 1x2 world of
    ``dryrun_world_child`` ranks, held alike, and each rank's outputs
    against its block of the one-device program's.  No kernel runs
    (``attn_impl="jnp"``, the plain ``tensordot`` aggregate, as in JAX's
    dry run); returns the second world's launches per rank (none)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_host_mesh
    t_phase = time.perf_counter()
    failures = []
    out_dir = ROOT / "build" / "chip_smoke" / "dryrun"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    torch.cuda.empty_cache()
    started = start_ranks(DRYRUN_CHILD, [str(out_dir)],
                          DRYRUN_FL["mesh"][0] * DRYRUN_FL["mesh"][1], env)
    fake = {}
    t0 = time.perf_counter()
    fake["train"] = dryrun_programs("train", None)[0].analyze()
    with fake_world(2):
        fake["fl"] = dryrun_programs(
            "fl", make_host_mesh(*DRYRUN_FL["mesh"]))[0].analyze()
    fake_secs = time.perf_counter() - t0
    res, secs = wait_ranks(started, timeout=600)
    bad = [(r, rc, err[-2000:]) for r, (rc, _, err) in enumerate(res)
           if rc != 0]
    if bad:
        raise AssertionError(f"dryrun FL world: ranks failed {bad}")
    real = {"fl": [json.loads((out_dir / f"rank{r}.json").read_text())
                   for r in range(len(res))]}
    low, vocab = dryrun_programs("train", None)
    real["train"] = [dryrun_real(torch, low, vocab)[0]]
    del low
    out = {}
    for which in ("train", "fl"):
        f = fake[which]
        mem = f["memory"]
        predicted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        want = [list(c) for c in f["collectives"]]
        ranks = []
        for r in real[which]:
            ratio = r["peak_bytes"] / predicted
            ranks.append(dict(r, peak_over_predicted=ratio,
                              collectives=len(r["collectives"])))
            if r["collectives"] != want:
                failures.append(f"{which}: rank {r.get('rank', 0)}'s "
                                "collective record differs from the fake "
                                "world's")
            if r["flops"] != int(f["flops"]):
                failures.append(f"{which}: {r['flops']} FLOPs counted on "
                                f"the card, {f['flops']} on fake tensors")
            if not DRYRUN_BAND[0] <= ratio <= DRYRUN_BAND[1]:
                failures.append(f"{which}: peak {r['peak_bytes']} is "
                                f"{ratio:.4f} of the predicted {predicted}")
            if not r["finite_loss"]:
                failures.append(f"{which}: the loss is not finite")
        out[which] = {"predicted_peak_bytes": predicted, "memory": mem,
                      "flops": f["flops"], "bytes_accessed": f["bytes"],
                      "collectives": len(want),
                      "collective_bytes": sum(c[2] for c in want),
                      "per_rank": ranks}
    out["train"]["config"] = dict(zip(("arch", "batch", "seq"),
                                      DRYRUN_TRAIN))
    out["fl"]["config"] = DRYRUN_FL
    # the second world: DRYRUN_WORLD's programs on 1x2
    wdir = out_dir / "world"
    wdir.mkdir()
    torch.cuda.empty_cache()
    started = start_ranks(DRYRUN_WORLD_CHILD, [str(wdir)], 2, env)
    t0 = time.perf_counter()
    # per program the fake rank 0's analysis; where the cache's sequence
    # splits, rank 0 holds the written position and rank 1 does not, so
    # rank 1 is held to the analysis of a position outside rank 0's slice
    wfake = {}
    with fake_world(2):
        mesh = make_host_mesh(1, 2)
        for name, _, _, _, S in DRYRUN_WORLD:
            low = dryrun_world_program(name, mesh)[0]
            wfake[name] = [low.analyze()]
            if not name.startswith(("f_", "g_")) and \
                    dryrun._cache_seq_axes(low.arg_specs[1]):
                wfake[name].append(dryrun_world_program(
                    name, mesh, pos=S - 1)[0].analyze())
    wfake_secs = time.perf_counter() - t0
    res, wsecs = wait_ranks(started, timeout=600)
    bad = [(r, rc, err[-2000:]) for r, (rc, _, err) in enumerate(res)
           if rc != 0]
    if bad:
        raise AssertionError(f"dryrun 1x2 world: ranks failed {bad}")
    wranks = [json.loads((wdir / f"rank{r}.json").read_text())
              for r in range(len(res))]
    world = {}
    for name, arch, cache, B, S in DRYRUN_WORLD:
        f = wfake[name][0]
        predicted = [a["memory"]["argument_size_in_bytes"]
                     + a["memory"]["temp_size_in_bytes"] for a in wfake[name]]
        want = [list(c) for c in f["collectives"]]
        ranks = []
        for rk in wranks:
            r = dict(rk["programs"][name])
            pred = predicted[min(rk["rank"], len(predicted) - 1)]
            ratio = r["peak_bytes"] / pred
            same = r.pop("collectives") == want
            ranks.append(dict(r, rank=rk["rank"], peak_over_predicted=ratio,
                              record_equal=same))
            tag = f"{name} rank {rk['rank']}"
            if not same:
                failures.append(f"{tag}: the collective record differs "
                                "from the fake world's")
            if r["flops"] != int(f["flops"]):
                failures.append(f"{tag}: {r['flops']} FLOPs counted on the "
                                f"card, {f['flops']} on fake tensors")
            if not DRYRUN_BAND[0] <= ratio <= DRYRUN_BAND[1]:
                failures.append(f"{tag}: peak {r['peak_bytes']} is "
                                f"{ratio:.4f} of the predicted {pred}")
            if not r["finite_loss"]:
                failures.append(f"{tag}: outputs not finite")
            if name.startswith("g_"):
                if not r["worst_rel"] <= DRYRUN_FSDP_REL:
                    failures.append(f"{tag}: relative difference "
                                    f"{r['worst_rel']} from the one-card "
                                    f"step, bound {DRYRUN_FSDP_REL}")
            elif not r["worst_share"] <= 1.0:
                failures.append(f"{tag}: {r['worst_share']} of the parity "
                                "tolerance from the one-device block")
        world[name] = {"arch": arch, "cache_shard": cache, "batch": B,
                       "seq": S, "predicted_peak_bytes": predicted,
                       "memory": f["memory"], "flops": f["flops"],
                       "bytes_accessed": f["bytes"],
                       "collectives": len(want),
                       "collective_bytes": sum(c[2] for c in want),
                       "per_rank": ranks}
    launches = {k: [rk["launches"][k] for rk in wranks]
                for k in ("fedagg", "distill", "flash")}
    if any(any(v) for v in launches.values()):
        failures.append(f"dryrun 1x2 world: kernels launched {launches}")
    emit({"phase": "dryrun", **out, "world_1x2": world, "band": DRYRUN_BAND,
          "fsdp_rel_bound": DRYRUN_FSDP_REL, "world_launches": launches,
          "fake_seconds": fake_secs, "fl_world_seconds": secs,
          "world_fake_seconds": wfake_secs, "world_seconds": wsecs,
          "seconds": time.perf_counter() - t_phase})
    if failures:
        raise AssertionError(f"dryrun: {failures}")
    return launches


def tensor_share(torch, got, want):
    """{"share": the largest |got - want| / (atol + rtol |want|),
    "max_abs_diff"} of a tensor on the card against one of the same shape
    (on the card or in host memory), a 2-D slice at a time."""
    def pairs(a, b):
        if a.dim() <= 2:
            yield a, b.to(a.device)
        else:
            for x, y in zip(a.unbind(0), b.unbind(0)):
                yield from pairs(x, y)

    share = diff = 0.0
    for a, b in pairs(got, want):
        d = (a - b).abs()
        share = max(share, float((d / (PARITY_ATOL
                                       + PARITY_RTOL * b.abs())).max()))
        diff = max(diff, float(d.max()))
    return {"share": share, "max_abs_diff": diff}


def lm_world(env, out_dir, mode, participants, model="olmo"):
    """An LM world of two ``tp_lm_child`` ranks on ``model`` in ``mode``
    ("tp" or "gather") at ``participants``: (their records, its
    seconds)."""
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    res, secs = wait_ranks(start_ranks(
        TP_LM_CHILD, [str(out_dir), mode, str(participants), model], 2,
        env), timeout=900)
    bad = [(r, rc, err[-2000:]) for r, (rc, _, err) in enumerate(res)
           if rc != 0]
    if bad:
        raise AssertionError(f"{model} {mode} world at {participants} "
                             f"participants: ranks failed {bad}")
    return [json.loads((out_dir / f"rank{r}.json").read_text())
            for r in range(2)], secs


def check_lm_ranks(recs, want, allowed, label, failures):
    """Hold each rank record of an LM world: its member losses against
    ``want`` within ``allowed`` shares of the parity tolerance, its
    launches (and flash's by query heads) as the code implies; under the
    TP forward whole-leaf copies equal and no plane column gathered
    inside a block beyond its outputs, on the gather path the plane's
    columns gathered in every block.  Appends what fails to ``failures``
    and returns the records trimmed for the phase line."""
    out = []
    for rec in recs:
        r, got = rec["rank"], rec.pop("block_losses")
        shares = [[tolerance_share(a, b) for a, b in zip(gl, wl)]
                  for (_, gl), (_, wl) in zip(got, want)]
        if ([lv for lv, _ in got] != [lv for lv, _ in want]
                or any(x > a for sb, ab in zip(shares, allowed)
                       for x, a in zip(sb, ab))):
            failures.append(f"{label} rank {r}: loss shares {shares}, "
                            f"allowed {allowed}")
        if (rec["launches"] != rec["expected_launches"]
                or rec["tp"] != (rec["mode"] == "tp")):
            failures.append(f"{label} rank {r}: tp {rec['tp']}, launches "
                            f"{rec['launches']}, expected "
                            f"{rec['expected_launches']}")
        if (rec["flash_launches_by_heads"]
                != rec["expected_flash_launches_by_heads"]):
            failures.append(f"{label} rank {r}: flash launches by heads "
                            f"{rec['flash_launches_by_heads']}, expected "
                            f"{rec['expected_flash_launches_by_heads']}")
        pr = rec.pop("probe")
        over = [b for b in pr["blocks"] if b["plane_gathers"] > b["outputs"]]
        if rec["mode"] == "tp":
            wrong = over or pr["replica_mismatches"] or not pr["replica_checks"]
        else:
            wrong = not pr["blocks"] or len(over) != len(pr["blocks"])
        if wrong:
            failures.append(f"{label} rank {r}: probe {pr}")
        rec.update(loss_share_by_round=shares,
                   replica_checks=pr["replica_checks"],
                   replica_mismatches=pr["replica_mismatches"],
                   plane_gathers_per_block=[b["plane_gathers"]
                                            for b in pr["blocks"]])
        out.append(rec)
    return out


def nudge_allowance(nudged, want):
    """Per block and round, the parity tolerance's share that a one-ulp
    nudge of the initial parameters moves the member losses by, and what
    a mesh run is allowed: MESH_NUDGE_FACTOR times that, at least 1."""
    nudge = [[tolerance_share(a, b) for a, b in zip(nl, wl)]
             for (_, nl), (_, wl) in zip(nudged, want)]
    return nudge, [[max(1.0, MESH_NUDGE_FACTOR * x) for x in blk]
                   for blk in nudge]


def phase_tp(torch, dev, env, tp_state, lm_ref):
    """Phase 21, ``tp``: the tensor-parallel member forward on the card.
    (a) The CNN worlds the mesh phase ran with the TP forward (1x2, 2x2):
    besides ``world_checks``, each rank unravelled only TP planes whose
    whole leaves' copies are equal in every chunk, gathered no plane
    column along ``model`` inside a block beyond the block's outputs at
    its end, and gave fedagg its (C/n, d_loc) blocks.  (b) lm_main's
    federation on a 1x2 mesh of two rank processes (``tp_lm_child``):
    flash on each rank's local heads, launches as the code implies, the
    per-round member losses against lm_main's within the parity tolerance
    or MESH_NUDGE_FACTOR times what a one-ulp nudge of lm_main's initial
    parameters moves them (run here first); fedagg at the ranks' shapes
    and flash at the local-head shape held against their plain versions
    and timed beside their bounds and library calls.  (c) At
    LM_CUT_PARTICIPANTS, lm_main unsharded here, then the gather path's
    1x2 world and the TP forward's, each held to it within the parity
    tolerance (``check_lm_ranks``), fedagg checked at their shapes.  All:
    per-rank peak memory, seconds and collective bytes per round.
    Returns the launches per rank of each world."""
    from repro_torch.core import server as srv
    from repro_torch.kernels.fedagg import ops as f_ops, ref as f_ref
    from repro_torch.kernels.flash import ops as a_ops, ref as a_ref
    failures = list(tp_state["failures"])
    # (a) the CNN worlds
    cnn = {}
    for name, run in tp_state["runs"].items():
        for rk in run["per_rank"]:
            pr = rk.pop("probe")
            chunks = set(pr["chunk"].values())
            blocks_over = [b for b in pr["blocks"]
                           if b["plane_gathers"] > b["outputs"]]
            if not (pr["tp"] and pr["replica_checks"]
                    and not pr["replica_mismatches"] and not blocks_over):
                failures.append(f"tp {name} rank {rk['rank']}: probe "
                                f"{ {k: v for k, v in pr.items() if k != 'blocks'} }, "
                                f"blocks over {blocks_over}")
            if not any(c in chunks for _, c in rk["fedagg_shapes"]):
                failures.append(f"tp {name} rank {rk['rank']}: no fedagg "
                                f"call on a chunk {chunks}: "
                                f"{rk['fedagg_shapes']}")
            rk.update(replica_checks=pr["replica_checks"],
                      replica_mismatches=pr["replica_mismatches"],
                      blocks=len(pr["blocks"]),
                      plane_gathers_per_block=[b["plane_gathers"]
                                               for b in pr["blocks"]],
                      outputs_per_block=[b["outputs"] for b in pr["blocks"]],
                      collectives_per_round=pr["collectives"],
                      chunk=sorted(chunks))
        cnn[name] = run
    gather = tp_state["gather"]
    if gather is not None:
        gather = {"process_seconds": gather["process_seconds"],
                  "per_rank": [{"peak_mem_bytes": rk["peak_mem_bytes"],
                                "seconds": rk["seconds"],
                                "collectives_per_round":
                                    rk["probe"]["collectives"]}
                               for rk in gather["per_rank"]]}

    # (b) the LM: lm_main nudged by one ulp here, then the 1x2 world
    torch.cuda.empty_cache()
    _, _, lmn, ltest, _ = lm_main_engine(srv, torch, "cuda",
                                         nudge=2.0 ** -23)
    lmn.train(ltest)
    nud_losses = lmn.block_losses
    del lmn
    torch.cuda.empty_cache()
    tp_root = ROOT / "build" / "chip_smoke" / "tp"
    recs, lm_secs = lm_world(env, tp_root / "full", "tp", LM_PARTICIPANTS)
    want = lm_ref["block_losses"]
    nudge, allowed = nudge_allowance(nud_losses, want)
    lm_ranks = check_lm_ranks(recs, want, allowed, "tp LM", failures)
    # (c) at the cut member count: the unsharded run here, then the gather
    # path's world and the TP forward's, each held to it
    torch.cuda.empty_cache()
    _, _, lmc, ctest, _ = lm_main_engine(srv, torch, "cuda",
                                         participants=LM_CUT_PARTICIPANTS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lmc.train(ctest)
    torch.cuda.synchronize()
    cut = {"participants": LM_CUT_PARTICIPANTS,
           "capacity": {str(l): lmc._capacity(len(m))
                        for l, m in lmc.assignment.members.items() if m},
           "unsharded": {"train_seconds": time.perf_counter() - t0,
                         # this process's peak, with what earlier phases
                         # still hold
                         "peak_mem_bytes": torch.cuda.max_memory_allocated()}}
    cut_losses = lmc.block_losses
    del lmc
    torch.cuda.empty_cache()
    for mode in ("gather", "tp"):
        recs, secs = lm_world(env, tp_root / f"cut_{mode}", mode,
                              LM_CUT_PARTICIPANTS)
        cut[mode] = {"process_seconds": secs, "per_rank": check_lm_ranks(
            recs, cut_losses, [[1.0] * len(l) for _, l in cut_losses],
            f"tp LM cut {mode}", failures)}
    fed_timed = {}
    for C, D in sorted({tuple(x) for rk in lm_ranks
                        for x in rk["fedagg_shapes"]}):
        x, w, err = check_fedagg(torch, f_ops, f_ref, dev, C, D)
        fed_timed[f"{C}x{D}"] = dict(time_fedagg(torch, f_ops, f_ref, x, w),
                                     max_abs_err=err)
        del x, w
    for C, D in sorted({tuple(x) for mode in ("gather", "tp")
                        for rk in cut[mode]["per_rank"]
                        for x in rk["fedagg_shapes"]} - {
                            tuple(map(int, k.split("x"))) for k in fed_timed}):
        x, w, err = check_fedagg(torch, f_ops, f_ref, dev, C, D)
        cut.setdefault("fedagg_checked", {})[f"{C}x{D}"] = err
        del x, w
    torch.cuda.empty_cache()
    H, hd, C0 = lm_ref["heads"] // 2, lm_ref["head_dim"], lm_ref["capacity"]
    B = LM_FL["local_batch"]
    flash_local = check_flash(torch, a_ops, a_ref, dev, {
        "name": "tp_lm_member_step_local_heads", "bh": C0 * B * H,
        "kv_rows": C0 * B * H, "H": H, "S": LM_SEQ, "hd": hd,
        "dtype": "float32", "causal": True, "window": 0, "softcap": 0.0})
    emit({"phase": "tp", "cnn": {"argv": MESH_ARGS, "runs": cnn,
                                 "gather_2x2": gather,
                                 "allowed_shares": tp_state["allowed"]},
          "lm": {"config": "olmo-1b", "layers": "2 of 16", "mesh": "1x2",
                 "backend": "gloo", "heads_per_rank": H,
                 "process_seconds": lm_secs, "per_rank": lm_ranks,
                 "nudge_share_by_block": nudge, "allowed_by_block": allowed,
                 "fedagg_timed": fed_timed,
                 "flash_local_heads": flash_local,
                 "cut": cut},
          "tolerance": {"rtol": PARITY_RTOL, "atol": PARITY_ATOL,
                        "nudge_factor": MESH_NUDGE_FACTOR}})
    if failures:
        raise AssertionError(f"tp: {failures}")
    launches = {k: {f"cnn_{n}": [rk["launches"] if k == "fedagg"
                                 else rk["other_launches"][k]
                                 for rk in run["per_rank"]]
                    for n, run in cnn.items()}
                for k in ("fedagg", "distill", "flash")}
    for k in launches:
        launches[k]["lm_1x2"] = [rk["launches"][k] for rk in lm_ranks]
        for mode in ("gather", "tp"):
            launches[k][f"lm_1x2_{mode}_cut"] = [
                rk["launches"][k] for rk in cut[mode]["per_rank"]]
    return launches, flash_local


def phase_tp_families(torch, dev, env, moe_ref):
    """Phase 22, ``tp_families``: the tensor-parallel member forward of
    the other families on the card, over gloo.  (a) moe_main's federation
    (granite-moe at full width, 2 of 24 layers, 32 experts top-8,
    capacity dispatch, flash) on a 1x2 mesh of two ``tp_lm_child``
    processes: held as the tp phase holds lm_main's world (member losses
    against moe_main's within the parity tolerance or MESH_NUDGE_FACTOR
    times a one-ulp nudge's move, run here first; launches as the code
    implies; whole-leaf copies equal; no plane gather inside a block), the
    routers' choices against the unsharded forward's (a flip only at a
    near-tie), each rank's peak below moe_main's.  (b) xlstm-350m at full
    width (6 of 24 layers: 5 mLSTM, 1 sLSTM) on the same federation:
    unsharded and nudged here, then its 1x2 world, held alike.  (c)
    jamba's Mamba mixer and MoE FFN, and xlstm-350m's mLSTM and sLSTM
    blocks, at module level on 1x2 (``tp_module_child``): forward and
    per-member gradients against the unsharded module within the parity
    tolerance, not the nudge rule; on further seeds the mLSTM block's
    forward within its own unsharded card-against-host share (C10) and
    its gradients within the tolerance.  (d) In the same world, C8: a bf16
    template's TP member step sees and trains bf16 leaves, its gradients
    within ``TP_BF16_REL`` of the unsharded bf16 step's (``tp_bf16_member``).
    Then fedagg at the
    granite ranks' blocks and flash at their local-head GQA shape against
    their plain versions, timed, and fedagg at the xLSTM ranks' blocks
    against its plain version.  Returns each world's launches per rank
    and the timed kernels."""
    from repro_torch.core import server as srv
    from repro_torch.kernels.fedagg import ops as f_ops, ref as f_ref
    from repro_torch.kernels.flash import ops as a_ops, ref as a_ref
    failures, worlds, out = [], {}, {}
    root = ROOT / "build" / "chip_smoke" / "tp_families"
    refs = {"granite": moe_ref}
    for model in ("granite", "xlstm"):
        # granite at moe_main's member count, against its records; the
        # xLSTM at LM_CUT_PARTICIPANTS (``TP_XLSTM_PARTICIPANTS``)
        parts = LM_PARTICIPANTS if model == "granite" else \
            TP_XLSTM_PARTICIPANTS
        torch.cuda.empty_cache()
        if model not in refs:
            # the unsharded run at that count, here
            _, _, e, t, _ = lm_main_engine(srv, torch, "cuda", model=model,
                                           participants=parts)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            e.train(t)
            torch.cuda.synchronize()
            refs[model] = {"block_losses": e.block_losses,
                           "train_seconds": time.perf_counter() - t0,
                           "peak_mem_bytes":
                               torch.cuda.max_memory_allocated()}
            check_finite(torch, e, e.block_losses, {})
            del e
            torch.cuda.empty_cache()
        _, _, e, t, _ = lm_main_engine(srv, torch, "cuda", model=model,
                                       nudge=2.0 ** -23, participants=parts)
        e.train(t)
        nudged = e.block_losses
        del e
        torch.cuda.empty_cache()
        recs, secs = lm_world(env, root / model, "tp", parts, model)
        nudge, allowed = nudge_allowance(nudged, refs[model]["block_losses"])
        ranks = check_lm_ranks(recs, refs[model]["block_losses"], allowed,
                               f"tp_families {model}", failures)
        for rk in ranks:
            if (model == "granite" and rk["peak_mem_bytes"]
                    >= refs[model]["peak_mem_bytes"]):
                failures.append(f"{model} rank {rk['rank']}: peak "
                                f"{rk['peak_mem_bytes']} not below the "
                                f"unsharded {refs[model]['peak_mem_bytes']}")
            fl = rk["routing_flips"]
            if fl is not None and (not fl["routers"] or
                                   fl["max_gap_at_flip"] > TP_NEAR_TIE):
                failures.append(f"{model} rank {rk['rank']}: routing "
                                f"{fl}")
        worlds[model] = {
            "arch": LM_MODELS[model][0], "cut": LM_MODELS[model][1],
            "mesh": "1x2", "backend": "gloo",
            "participants": parts, "process_seconds": secs,
            "unsharded": {k: v for k, v in refs[model].items()
                          if k != "block_losses"},
            "nudge_share_by_block": nudge, "allowed_by_block": allowed,
            "per_rank": ranks}
    # (c) jamba at module level
    mdir = root / "jamba_module"
    shutil.rmtree(mdir, ignore_errors=True)
    mdir.mkdir(parents=True)
    torch.cuda.empty_cache()
    res, secs = wait_ranks(start_ranks(TP_MODULE_CHILD, [str(mdir)], 2, env),
                           timeout=900)
    bad = [(r, rc, err[-2000:]) for r, (rc, _, err) in enumerate(res)
           if rc != 0]
    if bad:
        raise AssertionError(f"tp_families jamba module world: {bad}")
    mods = [json.loads((mdir / f"rank{r}.json").read_text())
            for r in range(2)]
    for rk in mods:
        for name, rec in rk["modules"].items():
            worst = max([rec["forward"]["share"]]
                        + [g["share"] for g in rec["grads"].values()])
            rec["worst_share"] = worst
            grads = max(g["share"] for g in rec["grads"].values())
            # C10: on every seed, splitting the mLSTM block over the ranks
            # adds no more error to its forward than a change of summation
            # order does (the unsharded block on the card against the
            # host); its gradients within the tolerance; the first seed
            # within the tolerance as before
            if name.startswith("mlstm"):
                fwd = rec["forward"]["share"]
                order = rec["card_vs_host_forward"]["share"]
                if not fwd <= order or not grads <= 1.0:
                    failures.append(f"{name} module rank {rk['rank']}: "
                                    f"forward share {fwd} against the order "
                                    f"noise {order}, gradients {grads}")
            if not worst <= 1.0 and not name.startswith("mlstm_seed"):
                failures.append(f"{name} module rank {rk['rank']}: worst "
                                f"share {worst}")

    def module_world(arch, names, what):
        return {"arch": arch, "mesh": "1x2", "backend": "gloo",
                "modules": what, "members": TP_MODULE_MEMBERS,
                "tokens_per_member": TP_MODULE_TOKENS,
                "process_seconds": secs,
                "per_rank": [dict(rk, modules={n: rk["modules"][n]
                                               for n in names})
                             for rk in mods]}

    worlds["jamba_module"] = module_world(
        TP_MODULE_ARCH, ("mamba", "moe"),
        "one Mamba mixer (d_inner 8192) and one MoE FFN (16 experts top-2, "
        "d_ff 14336, capacity dispatch), fp32")
    worlds["xlstm_module"] = module_world(
        TP_XLSTM_ARCH, ("mlstm", "slstm") + tuple(
            f"mlstm_seed{s}" for s in TP_MLSTM_SEEDS),
        "one mLSTM block (d_inner 2048, 4 heads, chunkwise) and one sLSTM "
        "block (4 heads, its GeGLU projection), fp32; held to the parity "
        "tolerance, not the nudge rule; the mLSTM block again on the "
        "seeds TP_MLSTM_SEEDS")
    worlds["xlstm_module"]["mlstm_forward_shares"] = {
        n: [m["forward"]["share"], m["card_vs_host_forward"]["share"]]
        for n, m in mods[0]["modules"].items() if n.startswith("mlstm")}
    # (d) C8: a bf16 template's TP member step
    bf16 = [rk["bf16_member"] for rk in mods]
    for r, b in enumerate(bf16):
        bad = {k: v for k, v in b["dtypes"].items()
               if v != ["torch.bfloat16"]}
        worst = max(x["tp_vs_bf16"] for x in b["leaves"])
        b["worst_tp_vs_bf16"] = worst
        b["worst_bf16_vs_fp32"] = max(x["bf16_vs_fp32"] for x in b["leaves"])
        if bad or not b["finite"] or not worst <= TP_BF16_REL:
            failures.append(f"bf16 member rank {r}: dtypes {bad}, finite "
                            f"{b['finite']}, worst leaf {worst} against "
                            f"{TP_BF16_REL}")
    worlds["bf16_member"] = {"mesh": "1x2", "backend": "gloo",
                             "members": TP_MODULE_MEMBERS,
                             "tokens_per_member": TP_MODULE_TOKENS,
                             "bound": TP_BF16_REL, "per_rank": bf16}
    # the kernels at the granite ranks' shapes
    granite = worlds["granite"]["per_rank"]
    for C, D in sorted({tuple(x) for rk in granite
                        for x in rk["fedagg_shapes"]}):
        x, w, err = check_fedagg(torch, f_ops, f_ref, dev, C, D)
        out.setdefault("fedagg", {})[f"{C}x{D}"] = dict(
            time_fedagg(torch, f_ops, f_ref, x, w), max_abs_err=err,
            launches=[rk["launches"]["fedagg"] for rk in granite])
        del x, w
    for C, D in sorted({tuple(x) for rk in worlds["xlstm"]["per_rank"]
                        for x in rk["fedagg_shapes"]}):
        x, w, err = check_fedagg(torch, f_ops, f_ref, dev, C, D)
        out.setdefault("fedagg_checked", {})[f"{C}x{D}"] = err
        del x, w
    torch.cuda.empty_cache()
    C0 = moe_ref["capacity"]
    H, KV, hd = (moe_ref["heads"] // 2, moe_ref["kv_heads"] // 2,
                 moe_ref["head_dim"])
    B = LM_FL["local_batch"]
    out["flash"] = check_flash(torch, a_ops, a_ref, dev, {
        "name": "granite_tp_member_step_local_heads", "bh": C0 * B * H,
        "kv_rows": C0 * B * KV, "H": H, "S": LM_SEQ, "hd": hd,
        "dtype": "float32", "causal": True, "window": 0, "softcap": 0.0})
    out["flash"]["launches"] = [rk["launches"]["flash"] for rk in granite]
    emit({"phase": "tp_families", "worlds": worlds, "kernels": out,
          "tolerance": {"rtol": PARITY_RTOL, "atol": PARITY_ATOL,
                        "nudge_factor": MESH_NUDGE_FACTOR,
                        "near_tie": TP_NEAR_TIE,
                        "bf16_leaf_rel": TP_BF16_REL}})
    if failures:
        raise AssertionError(f"tp_families: {failures}")
    launches = {k: {f"{m}_1x2": [rk["launches"][k]
                                 for rk in worlds[m]["per_rank"]]
                    for m in ("granite", "xlstm")}
                for k in ("fedagg", "distill", "flash")}
    return launches, out


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is visible; this script runs "
                 "the port on an NVIDIA card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        sys.exit(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} is missing; "
                 "run the script from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import ModelConfig, get_config
    from repro_torch.core import distill, server as srv
    from repro_torch.core.families import cnn_family, lm_family
    from repro_torch.core.scaling import compress_config, param_count
    from repro_torch.kernels import _build
    from repro_torch.kernels.distill import ops as d_ops, ref as d_ref
    from repro_torch.kernels.fedagg import ops as f_ops, ref as f_ref
    from repro_torch.kernels.flash import ops as a_ops, ref as a_ref
    from repro_torch.ckpt.manifest import CheckpointManager
    from repro_torch.ckpt.run_state import make_checkpointer
    from repro_torch.launch import fl_train
    from repro_torch.obs import make_observability
    from repro_torch.obs import validate as obs_validate
    from repro_torch.sim import HeterogeneitySim, SimConfig, make_trace
    from repro_torch.sim.faults import compare_reports

    def zero_counts():
        f_ops.weighted_aggregate.launches = 0
        d_ops.kd_loss_rows.launches = 0
        a_ops.flash_attention_bh.launches = 0

    def read_counts():
        return {"fedagg": f_ops.weighted_aggregate.launches,
                "distill": d_ops.kd_loss_rows.launches,
                "flash": a_ops.flash_attention_bh.launches}

    # 1. device -----------------------------------------------------------
    smi = smi_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "cudnn_allow_tf32": False,
          "matmul_allow_tf32": False})

    # 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {n: str(_build.library_path(n).relative_to(ROOT))
                        for n in _build.SOURCES},
          # each kernel's name, then its registers, shared memory, spills,
          # and any wgmma serialisation ptxas reports
          "ptxas": {n: [l.strip() for l in log.splitlines()
                        if "entry function" in l or "registers" in l
                        or "spill" in l or "Performance Loss" in l]
                    for n, log in logs.items()}})

    # the main paths' engines, set up (host-side Procedure 1 and 2) so the
    # kernels are checked and timed at the shapes they will give them
    parts, cd, test = federation(40, 2400, 3)
    cfg = srv.FLConfig(rounds=4, rounds_per_dispatch=4, compact_to=4, seed=3)
    Recording, TokenFedRAC = engines(srv, torch)
    eng = Recording(parts, cd, cnn_family(base_width=1.0), cfg, classes=10,
                    device="cuda").setup()
    members = eng.assignment.members
    live = [l for l in range(eng.m) if members.get(l)]
    main_shapes = {l: (eng._capacity(len(members[l])),
                       eng.plane_spec(l).d_pad) for l in live}
    n_test = len(test["y"])

    lm_base, lm_cfg, lm, ltest, corpus_s = lm_main_engine(srv, torch, "cuda")
    lm_cut = {"n_layers": "2 of 16", "rounds": 2, "steps_per_round": 2,
              "local_batch": 4, "seq": LM_SEQ,
              "corpus_tokens": LM_CORPUS_TOKENS,
              "participants": LM_PARTICIPANTS, "weights": "random, seeded",
              "data": "synthetic Markov corpus (make_lm_corpus)"}
    lm_members = lm.assignment.members
    lm_live = [l for l in range(lm.m) if lm_members.get(l)]
    if not (0 in lm_live and any(l > 0 for l in lm_live)):
        raise AssertionError(f"the LM federation needs a master and a slave "
                             f"cluster, got {lm_members}")
    lm_sizes = {l: param_count(compress_config(lm_base, 0.5, l))
                for l in range(lm.m)}
    lm_shapes = {l: (lm._capacity(len(lm_members[l])),
                     lm.plane_spec(l).d_pad) for l in lm_live}
    cap_max = max(c for c, _ in lm_shapes.values())
    if cap_max > 8:
        raise AssertionError(f"LM capacity {cap_max} > 8 does not fit the "
                             "memory reckoning")
    H, hd = lm_base.n_heads, lm_base.head_dim
    B = lm_cfg.local_batch

    # the MoE main path: granite-moe-1b-a400m at full width, two of its 24
    # layers, on lm_main's federation, schedule and engine
    moe_base, _, meng, mtest, _ = lm_main_engine(srv, torch, "cuda",
                                                 model="granite")
    moe_members = meng.assignment.members
    moe_live = [l for l in range(meng.m) if moe_members.get(l)]
    if not (0 in moe_live and any(l > 0 for l in moe_live)):
        raise AssertionError(f"the MoE federation needs a master and a slave "
                             f"cluster, got {moe_members}")
    moe_shapes = {l: (meng._capacity(len(moe_members[l])),
                      meng.plane_spec(l).d_pad) for l in moe_live}
    if max(c for c, _ in moe_shapes.values()) > 8:
        raise AssertionError(f"MoE capacities {moe_shapes} exceed 8, the "
                             "memory reckoning's")

    # 3. kernels ----------------------------------------------------------
    fed_shapes = sorted(set(main_shapes.values()) | {(16, 1_629_440),
                                                     (16, 409_216)})
    fed_checks = {}
    for C in (1, 3, 64):
        for D in (128, 2176):
            fed_checks[(C, D)] = check_fedagg(torch, f_ops, f_ref, dev, C,
                                              D)[2]
    fed_timed = {}
    for C, D in fed_shapes + [lm_shapes[0]]:
        x, w, err = check_fedagg(torch, f_ops, f_ref, dev, C, D)
        fed_checks[(C, D)] = err
        fed_timed[(C, D)] = dict(time_fedagg(torch, f_ops, f_ref, x, w),
                                 max_abs_err=err)
        del x, w
        torch.cuda.empty_cache()
    for C, D in moe_shapes.values():          # checked, not timed
        x, w, fed_checks[(C, D)] = check_fedagg(torch, f_ops, f_ref, dev, C,
                                                D)
        del x, w
        torch.cuda.empty_cache()
    fed_wrappers = check_fedagg_wrappers(torch, f_ops, f_ref, dev)
    emit({"phase": "kernels", "kernel": "fedagg",
          "tolerance": {"rtol": FEDAGG_RTOL, "atol": FEDAGG_ATOL},
          "max_abs_err": {f"{C}x{D}": e for (C, D), e in fed_checks.items()},
          "timed": {f"{C}x{D}": v for (C, D), v in fed_timed.items()},
          "wrappers": fed_wrappers})
    V_lm = lm_base.padded_vocab
    n_lm_test = len(ltest["tokens"])
    V_moe, n_moe_test = moe_base.padded_vocab, len(mtest["tokens"])
    dist_cases = [(n_test, 10, torch.float32), (256, 10, torch.float32),
                  (8, 7000, torch.float32), (n_lm_test, V_lm, torch.float32),
                  (n_moe_test, V_moe, torch.float32),
                  (512, 151_936, torch.float32), (7, 151_936, torch.float32),
                  (16, 512, torch.bfloat16)]
    dist_timed = {}
    for N, V, dt in dist_cases:
        args, err = check_distill(torch, d_ops, d_ref, dev, N, V, dt)
        dist_timed[(N, V, str(dt))] = dict(
            time_distill(torch, d_ops, d_ref, args), max_abs_err=err)
        del args
    emit({"phase": "kernels", "kernel": "distill",
          "tolerance": "tests/test_distill.py: |mean - plain| < 1e-3 "
                       "(fp32) or 5e-2 (bf16) times max(1, |plain|); two "
                       "calls give the same bits",
          "timed": {f"{N}x{V}:{dt}": v
                    for (N, V, dt), v in dist_timed.items()}})

    def flash_case(name, B, H, KV, S, hd, dtype="float32", causal=True,
                   window=0, softcap=0.0):
        return {"name": name, "bh": B * H, "kv_rows": B * KV, "H": H,
                "S": S, "hd": hd, "dtype": dtype, "causal": causal,
                "window": window, "softcap": softcap}

    C0 = lm_shapes[0][0]
    Cm = moe_shapes[0][0]
    mH, mKV, mhd = moe_base.n_heads, moe_base.n_kv_heads, moe_base.head_dim
    flash_cases = [
        flash_case("lm_main_member_step", C0 * B, H, H, LM_SEQ, hd),
        flash_case("lm_main_member_step_bf16", C0 * B, H, H, LM_SEQ, hd,
                   "bfloat16"),
        flash_case("granite_moe_member_step", Cm * B, mH, mKV, LM_SEQ, mhd),
        flash_case("granite_moe_member_step_bf16", Cm * B, mH, mKV, LM_SEQ,
                   mhd, "bfloat16"),
        flash_case("qwen3-8b_gqa", 1, 32, 8, 2048, 128),
        flash_case("qwen3-8b_gqa_bf16", 1, 32, 8, 2048, 128, "bfloat16"),
        flash_case("minicpm-2b_hd64", 1, 36, 36, 2048, 64),
        flash_case("minicpm-2b_hd64_bf16", 1, 36, 36, 2048, 64, "bfloat16"),
        flash_case("gemma2-9b_local", 1, 16, 8, 8192, 256, window=4096,
                   softcap=50.0),
        flash_case("gemma2-9b_local_bf16", 1, 16, 8, 8192, 256, "bfloat16",
                   window=4096, softcap=50.0),
        flash_case("ragged_s300_hd128", 2, 16, 16, 300, 128),
        flash_case("non_causal_hd32", 2, 4, 4, 64, 32, causal=False),
        flash_case("non_causal_hd8", 2, 4, 2, 64, 8, causal=False),
        flash_case("ragged_s17_hd8", 4, 4, 4, 17, 8)]
    flash_timed = {}
    for case in flash_cases:
        flash_timed[case["name"]] = check_flash(torch, a_ops, a_ref, dev,
                                                case)
        emit({"phase": "kernels", "kernel": "flash",
              **flash_timed[case["name"]]})

    # 4. main path, full width --------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    res = eng.train(test)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    xt = torch.as_tensor(test["x"], device=dev)
    yt = torch.as_tensor(test["y"], device=dev)
    kd_report = {}
    with torch.no_grad():
        _, t_logits = eng.family.loss_and_logits(0, eng.master_params,
                                                 {"x": xt, "y": yt})
        for level, p in eng.cluster_params.items():
            if level == 0:
                continue
            _, s_logits = eng.family.loss_and_logits(level, p,
                                                     {"x": xt, "y": yt})
            kd_report[level] = float(distill.kd_loss(
                s_logits, yt, t_logits, T=cfg.kd_T, alpha=cfg.kd_alpha,
                use_kernel=True))
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    cnn_launches = read_counts()
    dispatched = cfg.rounds * len(live)
    if not (dispatched > 0 and cnn_launches["fedagg"] == dispatched):
        raise AssertionError(f"fedagg launched {cnn_launches['fedagg']} "
                             f"times, expected {dispatched} dispatched rounds")
    slaves = [l for l in live if l > 0]
    if not (slaves and cnn_launches["distill"] == len(slaves)):
        raise AssertionError(f"distill launched {cnn_launches['distill']} "
                             f"times for slaves {slaves}")
    check_finite(torch, eng, eng.block_losses, kd_report)
    emit({"phase": "main", "k_optimal": eng.k_optimal, "m": eng.m,
          "di_values": {str(k): v for k, v in eng.di_values.items()},
          "members": {str(l): len(v) for l, v in members.items()},
          "capacity_and_d_pad": {str(l): list(v)
                                 for l, v in main_shapes.items()},
          "history": {str(l): h for l, h in res.history.items()},
          "global_acc": res.global_acc,
          "slave_kd_loss_vs_master": {str(l): v
                                      for l, v in kd_report.items()},
          "train_seconds": train_s, "main_seconds": main_s,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "launches": cnn_launches, "dispatched_rounds": dispatched})

    # 4b. where the time goes: the same train() again, warm
    emit(dict({"phase": "profile"},
              **profile_train(torch, eng, test, ("fedagg",))))

    # 4c. the simulator's main path, full width ---------------------------
    ShapeFedRAC, CountingSim = sim_classes(srv, HeterogeneitySim)

    def simulate(R, where="cuda", n_part=40, samples=2400, width=1.0,
                 policy="buffer", rounds=SIM_ROUNDS, eval_every=4,
                 compact_to=4, checkpoint=None, **sim_kw):
        """One simulator run on a fresh engine (trace events mutate the
        participants and the assignment), with the run-state checkpointer
        ``checkpoint`` if one is given; counts set to 0 just before
        ``sim.run`` and read just after."""
        p, c, tst = federation(n_part, samples, 3)
        e = ShapeFedRAC(p, c, cnn_family(base_width=width), srv.FLConfig(
            rounds_per_dispatch=R, staleness_discount=0.6,
            aggregation="buffered" if policy == "buffer" else "sync",
            compact_to=compact_to, seed=3), classes=10, device=where).setup()
        members0 = {str(l): len(v) for l, v in e.assignment.members.items()}
        sim = CountingSim(e, make_trace("mixed", n_part, rounds,
                                        seed=SIM_TRACE_SEED),
                          SimConfig(rounds=rounds, mar_policy=policy,
                                    schedule="parallel",
                                    eval_every=eval_every, **sim_kw),
                          obs=make_observability(trace=False),
                          checkpoint=checkpoint)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        rep = sim.run(tst)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return {"eng": e, "sim": sim, "report": rep, "seconds": secs,
                "n_test": len(tst["y"]),
                "launches": read_counts(), "members": members0,
                "peak_mem_bytes": torch.cuda.max_memory_allocated()}

    def check_sim(run, banked):
        """Launch counts as the records imply, one build per program,
        finite losses and planes."""
        e, sim, rep = run["eng"], run["sim"], run["report"]
        comp = int(sim.obs.registry.counter("agg/bank_compressions").value)
        want = {"fedagg": expected_fedagg_launches(rep.rows, sim.terminal,
                                                   comp, banked)
                if e.cfg.rounds_per_dispatch > 1 else 0,
                "distill": 0, "flash": 0}
        if run["launches"] != want:
            raise AssertionError(f"simulator launches {run['launches']}, "
                                 f"expected {want}")
        stats = e.compile_stats()
        if not stats or set(stats.values()) != {1}:
            raise AssertionError(f"programs built more than once: {stats}")
        for r in rep.rows:
            for c in r.clusters:
                if c.active and not math.isfinite(c.mean_loss):
                    raise AssertionError(f"round {r.round} cluster "
                                         f"{c.level}: loss {c.mean_loss}")
        for l, p in sim.params.items():
            if not bool(torch.isfinite(e.plane_of(l, p)).all()):
                raise AssertionError(f"simulated level {l} ended with a "
                                     "non-finite plane")
        return {"launches": run["launches"], "expected_launches": want,
                "terminal_flush_entries": {str(l): n for l, n
                                           in sim.terminal.items()},
                "bank_compressions": comp, "programs": len(stats),
                "builds_per_program": sorted(set(stats.values()))}

    sim_runs = {w: simulate(4) for w in ("cold", "warm")}
    sim_checks = {w: check_sim(r, banked=True) for w, r in sim_runs.items()}
    sim_rep = sim_runs["cold"]["report"]
    if sim_host_rows(sim_runs["warm"]["report"]) != sim_host_rows(sim_rep):
        raise AssertionError("two simulator runs of one trace disagree on "
                             "the host telemetry")
    sim_sum = sim_rep.summary()
    banked_rounds = sum(1 for r in sim_rep.rows for c in r.clusters
                        if c.banked)
    if not (banked_rounds and sim_sum["flushed_total"]):
        raise AssertionError(f"trace seed {SIM_TRACE_SEED} gives no banked "
                             f"block or no flush: {sim_sum}")
    sim_shapes = sorted(sim_runs["cold"]["eng"].fedagg_shapes
                        | sim_runs["warm"]["eng"].fedagg_shapes)
    sim_fed_err = {f"{C}x{D}": check_fedagg(torch, f_ops, f_ref, dev, C,
                                            D)[2] for C, D in sim_shapes}
    emit({"phase": "sim_main", "config": {
              "family": "cnn_family(base_width=1.0)", "participants": 40,
              "samples": 2400, "rounds": SIM_ROUNDS, "rounds_per_dispatch": 4,
              "aggregation": "buffered", "staleness_discount": 0.6,
              "compact_to": 4, "mar_policy": "buffer",
              "schedule": "parallel", "eval_every": 4,
              "trace": f"make_trace('mixed', 40, {SIM_ROUNDS}, "
                       f"seed={SIM_TRACE_SEED})"},
          "cut": {"rounds": SIM_ROUNDS, "trace": "synthetic, seeded",
                  "data": "synth-mnist (synthetic)",
                  "weights": "random, seeded"},
          "members_at_start": sim_runs["cold"]["members"],
          "sim_run_seconds": {w: r["seconds"] for w, r in sim_runs.items()},
          "peak_mem_bytes": {w: r["peak_mem_bytes"]
                             for w, r in sim_runs.items()},
          "simulated_wall_clock_s_host_arithmetic": sim_sum["wall_clock_s"],
          "participation_rate": sim_sum["participation_rate"],
          "mar_violations": sim_sum["mar_violations"],
          "banked_total": sim_sum["banked_total"],
          "flushed_total": sim_sum["flushed_total"],
          "banked_cluster_rounds": banked_rounds,
          "final_acc": sim_sum["final_acc"],
          "events": sum(len(r.events) for r in sim_rep.rows),
          "fedagg_shapes_max_abs_err": sim_fed_err,
          "fedagg_tolerance": {"rtol": FEDAGG_RTOL, "atol": FEDAGG_ATOL},
          "checks": sim_checks})

    # 4d. the same simulation on the one-round path -------------------------
    legacy = simulate(1)
    legacy_check = check_sim(legacy, banked=True)
    if sim_host_rows(legacy["report"]) != sim_host_rows(sim_rep):
        raise AssertionError("one-round and dispatch simulator runs differ "
                             "in host telemetry")
    emit({"phase": "sim_legacy", "sim_run_seconds": legacy["seconds"],
          "peak_mem_bytes": legacy["peak_mem_bytes"],
          "host_fields_equal_sim_main": True,
          "final_acc": legacy["report"].summary()["final_acc"],
          "checks": legacy_check})
    for r in list(sim_runs.values()) + [legacy]:
        del r["eng"], r["sim"]
    torch.cuda.empty_cache()

    # 5. cli --------------------------------------------------------------
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli = fl_train.main(["--participants", "16", "--rounds", "2",
                             "--base-width", "0.125", "--samples", "800",
                             "--device", "cuda"])
    emit({"phase": "cli", "seconds": time.perf_counter() - t0,
          "global_acc": cli.global_acc,
          "last_lines": buf.getvalue().strip().splitlines()[-2:]})

    # 6. card == CPU ------------------------------------------------------
    # deterministic cuDNN algorithms: the same convolution algorithm in
    # every run, so the card's distance from the CPU does not vary by run
    torch.backends.cudnn.deterministic = True
    finals, inits = {}, {}
    for where in ("cpu", "cuda"):
        p8, cd8, test8 = federation(8, 400, 3)
        e = srv.FedRAC(p8, cd8, cnn_family(base_width=0.125),
                       srv.FLConfig(rounds=2, rounds_per_dispatch=2,
                                    compact_to=2, seed=3),
                       classes=10, device=where).setup()
        inits[where] = {l: e.plane_of(l, e.init_params(l)).cpu()
                        for l in range(e.m)}
        e.train(test8)
        finals[where] = {l: e.plane_of(l, p).cpu()
                         for l, p in e.cluster_params.items()}
    parity = {}
    for l in finals["cpu"]:
        torch.testing.assert_close(inits["cuda"][l], inits["cpu"][l],
                                   rtol=0, atol=0)
        torch.testing.assert_close(finals["cuda"][l], finals["cpu"][l],
                                   rtol=PARITY_RTOL, atol=PARITY_ATOL)
        diff = (finals["cuda"][l] - finals["cpu"][l]).abs()
        allowed = PARITY_ATOL + PARITY_RTOL * finals["cpu"][l].abs()
        parity[str(l)] = {"max_abs_diff": float(diff.max()),
                          "worst_share_of_tolerance":
                              float((diff / allowed).max())}
    emit({"phase": "parity", "tolerance": {"rtol": PARITY_RTOL,
                                           "atol": PARITY_ATOL},
          "levels": parity})

    # 6b. the simulator, card == CPU --------------------------------------
    sim_parity = {}
    for policy, R in (("buffer", 2), ("mask", 1)):
        runs = {w: simulate(R, w, n_part=10, samples=600, width=0.125,
                            policy=policy, rounds=4, eval_every=2,
                            compact_to=2) for w in ("cpu", "cuda")}
        cpu, card = runs["cpu"]["report"], runs["cuda"]["report"]
        if sim_host_rows(card) != sim_host_rows(cpu):
            raise AssertionError(f"sim_parity {policy}: host fields differ")
        n_sim_test = runs["cpu"]["n_test"]
        share, acc_gap = 0.0, 0.0
        for rc, rg in zip(cpu.rows, card.rows):
            for cc, cg in zip(rc.clusters, rg.clusters):
                if math.isfinite(cc.mean_loss) != math.isfinite(cg.mean_loss):
                    raise AssertionError(f"sim_parity {policy}: loss "
                                         f"{cg.mean_loss} vs {cc.mean_loss}")
                if math.isfinite(cc.mean_loss):
                    share = max(share, abs(cg.mean_loss - cc.mean_loss)
                                / (PARITY_ATOL + PARITY_RTOL
                                   * abs(cc.mean_loss)))
                if cc.acc is not None:
                    acc_gap = max(acc_gap, abs(cg.acc - cc.acc))
        for l, a in cpu.final_acc.items():
            acc_gap = max(acc_gap, abs(card.final_acc[l] - a))
        for l in runs["cpu"]["sim"].params:
            pc = runs["cpu"]["eng"].plane_of(
                l, runs["cpu"]["sim"].params[l]).cpu()
            pg = runs["cuda"]["eng"].plane_of(
                l, runs["cuda"]["sim"].params[l]).cpu()
            torch.testing.assert_close(pg, pc, rtol=PARITY_RTOL,
                                       atol=PARITY_ATOL)
            share = max(share, float(((pg - pc).abs() / (
                PARITY_ATOL + PARITY_RTOL * pc.abs())).max()))
        if not share <= 1.0:
            raise AssertionError(f"sim_parity {policy}: losses outside the "
                                 f"tolerance (worst share {share})")
        if acc_gap > 1.0 / n_sim_test + 1e-9:
            raise AssertionError(f"sim_parity {policy}: accuracy gap "
                                 f"{acc_gap} > one of {n_sim_test} samples")
        if runs["cpu"]["launches"]["fedagg"] != 0:
            raise AssertionError("the CPU simulator launched a kernel")
        sim_parity[f"{policy}_R{R}"] = {
            "worst_share_of_tolerance": share, "max_acc_gap": acc_gap,
            "card_fedagg_launches": runs["cuda"]["launches"]["fedagg"]}
    emit({"phase": "sim_parity", "tolerance": {"rtol": PARITY_RTOL,
                                               "atol": PARITY_ATOL},
          "accuracy_tolerance": "one test sample", "runs": sim_parity})

    # 6c. the simulator's launcher, with its observability outputs -------
    out_dir = ROOT / "build" / "chip_smoke" / "sim_cli"
    out_dir.mkdir(parents=True, exist_ok=True)
    outs = {k: out_dir / f for k, f in (("metrics", "metrics.jsonl"),
                                        ("trace", "trace.json"),
                                        ("report", "report.json"))}
    cmd = [sys.executable, "-m", "repro_torch.launch.sim_run", "--trace",
           "mixed", "--mar-policy", "buffer", "--rounds-per-dispatch", "4",
           "--rounds", "4", "--participants", "8", "--samples", "600",
           "--base-width", "0.125", "--json", "--metrics-out",
           str(outs["metrics"]), "--trace-out", str(outs["trace"]),
           "--report-out", str(outs["report"]), "--fence"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [x for x in [os.environ.get("PYTHONPATH")]
                               if x]))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          env=env, cwd=ROOT)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"sim_run exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    metrics = obs_validate.validate_metrics_jsonl(outs["metrics"])
    trace_ok = obs_validate.validate_trace(outs["trace"],
                                           coverage_root="sim.run",
                                           min_coverage=0.95)
    totals = obs_validate.check_summary_parity(metrics, outs["report"])
    emit({"phase": "sim_cli", "seconds": cli_s, "exit_code": proc.returncode,
          "sim_run_span_coverage": trace_ok["coverage"],
          "trace_events": trace_ok["events"],
          "metrics_lines": metrics["lines"], "summary_parity": totals,
          "summary": json.loads(proc.stdout.strip().splitlines()[-1])[
              "summary"]})

    # 6d. the async server on sim_main's configuration ---------------------
    # run-to-run deterministic cuDNN (set since phase 6, said again here):
    # (a) compares two runs bit for bit
    torch.backends.cudnn.deterministic = True
    anchor = {"sync": simulate(4), "async": simulate(4, mode="async",
                                                      max_staleness=0)}
    anchor_checks = {k: check_sim(r, banked=True) for k, r in anchor.items()}
    rs, ra = anchor["sync"]["report"], anchor["async"]["report"]
    if sim_host_rows_per_cluster(ra) != sim_host_rows_per_cluster(rs):
        raise AssertionError("async at max_staleness=0: host fields differ "
                             "from the sync buffered run")
    compared = {"records": len(rs.rows), "plane_elements": 0}
    for f in ("mean_loss", "acc"):
        got = [getattr(c, f) for r in ra.rows for c in r.clusters]
        want = [getattr(c, f) for r in rs.rows for c in r.clusters]
        if not all(a == b or (a != a and b != b)
                   for a, b in zip(got, want)) or len(got) != len(want):
            raise AssertionError(f"async at max_staleness=0: per-round "
                                 f"{f} differs from the sync buffered run")
        compared[f] = len(got)
    for l, p in anchor["sync"]["sim"].params.items():
        ps = anchor["sync"]["eng"].plane_of(l, p)
        pa = anchor["async"]["eng"].plane_of(
            l, anchor["async"]["sim"].params[l])
        if not torch.equal(ps, pa):
            raise AssertionError(
                f"async at max_staleness=0: level {l} plane differs from "
                f"the sync buffered run by {float((ps - pa).abs().max())}")
        compared["plane_elements"] += ps.numel()
    async_runs = {w: simulate(4, mode="async", max_staleness=None)
                  for w in ("cold", "warm")}
    async_checks = {w: check_sim(r, banked=True)
                    for w, r in async_runs.items()}
    ar = async_runs["cold"]["report"]
    if sim_host_rows(async_runs["warm"]["report"]) != sim_host_rows(ar):
        raise AssertionError("two async runs of one trace disagree on the "
                             "host telemetry")
    # conservation is checked on each cluster record a merge files
    conservation = {w: r["sim"].conservation_checks
                    for w, r in async_runs.items()}
    for w, r in async_runs.items():
        filed = sum(len(x.clusters) for x in r["report"].rows)
        if conservation[w] != filed:
            raise AssertionError(f"async {w}: conservation checked on "
                                 f"{conservation[w]} of {filed} records")
    # fedagg against its plain version at every (C, D) of these runs
    async_shapes = sorted(set().union(*(r["eng"].fedagg_shapes for r in
                                        list(anchor.values())
                                        + list(async_runs.values()))))
    async_fed_err = {f"{C}x{D}": check_fedagg(torch, f_ops, f_ref, dev, C,
                                              D)[2] for C, D in async_shapes}
    areg = ar.registry
    merges = int(areg.counter("async/merges").value)
    emit({"phase": "async_main", "config": "sim_main's, mode='async'",
          "cudnn_deterministic": True,
          "anchor_max_staleness_0": {
              "bit_equal_compared": compared,
              "sim_run_seconds": {k: r["seconds"]
                                  for k, r in anchor.items()},
              "peak_mem_bytes": {k: r["peak_mem_bytes"]
                                 for k, r in anchor.items()},
              "checks": anchor_checks},
          "unbounded": {
              "sim_run_seconds": {w: r["seconds"]
                                  for w, r in async_runs.items()},
              "peak_mem_bytes": {w: r["peak_mem_bytes"]
                                 for w, r in async_runs.items()},
              "merges": merges,
              "conservation_checks": conservation,
              "version_lag": {k.rsplit("/", 1)[1]: g.value
                              for k, g in sorted(areg.gauges.items())
                              if k.startswith("async/version_lag/")},
              "staleness": areg.histogram("async/staleness").summary(),
              "async_wall_clock_s": areg.gauge("async/wall_clock_s").value,
              "sync_simulated_wall_clock_s": rs.summary()["wall_clock_s"],
              "banked_total": ar.summary()["banked_total"],
              "flushed_total": ar.summary()["flushed_total"],
              "final_acc": ar.summary()["final_acc"],
              "checks": async_checks},
          "fedagg_shapes_max_abs_err": async_fed_err,
          "fedagg_tolerance": {"rtol": FEDAGG_RTOL, "atol": FEDAGG_ATOL}})
    for r in list(anchor.values()) + list(async_runs.values()):
        del r["eng"], r["sim"]
    torch.cuda.empty_cache()

    # 6e. crash-safe resume ------------------------------------------------
    res_dir = ROOT / "build" / "chip_smoke" / "resume"
    shutil.rmtree(res_dir, ignore_errors=True)
    res_dir.mkdir(parents=True)
    # in process: the anchor's sync run and the unbounded async run, each
    # without checkpoints and then with one at every boundary (a round; a
    # merge event in async mode): the same bits, and what the writes cost
    ckpt_cost = {}
    for mode, kw in (("sync", {}),
                     ("async", {"mode": "async", "max_staleness": None})):
        ck = make_checkpointer(str(res_dir / f"in_process_{mode}"), every=1,
                               keep=3)
        writes = []

        def timed_save(*a, _save=ck.save, _writes=writes):
            t0 = time.perf_counter()
            path = _save(*a)
            _writes.append(time.perf_counter() - t0)
            return path

        ck.save = timed_save
        ref = simulate(4, **kw)
        run = simulate(4, checkpoint=ck, **kw)
        if sim_host_rows(run["report"]) != sim_host_rows(ref["report"]):
            raise AssertionError(f"checkpointed {mode} run: host fields "
                                 "differ from the run without checkpoints")
        for l, p in run["sim"].params.items():
            if not torch.equal(run["eng"].plane_of(l, p), ref["eng"].plane_of(
                    l, ref["sim"].params[l])):
                raise AssertionError(f"checkpointed {mode} run: level {l} "
                                     "plane differs from the run without "
                                     "checkpoints")
        with open(res_dir / f"in_process_{mode}" / "MANIFEST.json") as f:
            kept = json.load(f)["checkpoints"]
        ckpt_cost[mode] = {
            "sim_run_seconds": run["seconds"],
            "sim_run_seconds_without": ref["seconds"],
            "writes": len(writes), "write_seconds": writes,
            "overhead_seconds_per_write":
                (run["seconds"] - ref["seconds"]) / len(writes),
            "checkpoint_bytes": {str(e["step"]): sum(
                v["bytes"] for v in e["files"].values()) for e in kept}}
        del run["eng"], run["sim"], ref["eng"], ref["sim"]
    torch.cuda.empty_cache()
    # through the launcher, full width
    resume_base = ["--trace", "mixed", "--participants", "40", "--samples",
                   "2400", "--base-width", "1.0", "--compact-to", "4",
                   "--rounds", str(SIM_ROUNDS), "--rounds-per-dispatch", "4",
                   "--mar-policy", "buffer", "--staleness-discount", "0.6",
                   "--eval-every", "4", "--seed", str(SIM_TRACE_SEED)]
    libs = {n: _build.library_path(n).stat().st_mtime_ns
            for n in _build.SOURCES}
    resumed = resume_runs(resume_base, res_dir, env, compare_reports,
                          CheckpointManager)
    res_shapes = sorted({tuple(s) for rec in resumed["fedagg"].values()
                         for s in rec["shapes"]})
    res_fed_err = {f"{C}x{D}": check_fedagg(torch, f_ops, f_ref, dev, C,
                                            D)[2] for C, D in res_shapes}
    emit({"phase": "resume", "flags": resume_base,
          "participants": "sample_profiles(40, seed=3): the launcher's "
                          "Table-III resampling",
          "kernel_libraries_rebuilt": libs != {
              n: _build.library_path(n).stat().st_mtime_ns
              for n in _build.SOURCES},
          "in_process_checkpoint_cost": ckpt_cost, **resumed,
          "fedagg_shapes_max_abs_err": res_fed_err,
          "fedagg_tolerance": {"rtol": FEDAGG_RTOL, "atol": FEDAGG_ATOL}})

    # 7. LM main path, OLMo-1B width --------------------------------------
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    lres = lm.train(ltest)
    torch.cuda.synchronize()
    lm_train_s = time.perf_counter() - t0
    lm_block_losses = list(lm.block_losses)
    lt = torch.as_tensor(ltest["tokens"], device=dev)
    ly = lt[:, -1]
    lm_kd = {}
    with torch.no_grad():
        _, t_logits = lm.family.loss_and_logits(0, lm.master_params,
                                                {"tokens": lt})
        for level, p in lm.cluster_params.items():
            if level == 0:
                continue
            _, s_logits = lm.family.loss_and_logits(level, p, {"tokens": lt})
            lm_kd[level] = float(distill.kd_loss(
                s_logits, ly, t_logits, T=lm_cfg.kd_T, alpha=lm_cfg.kd_alpha,
                use_kernel=True))
    torch.cuda.synchronize()
    lm_main_s = time.perf_counter() - t0
    lm_peak = torch.cuda.max_memory_allocated()
    lm_launches = read_counts()
    L = lm_base.n_layers
    R, steps = lm_cfg.rounds, lm_cfg.steps_per_round
    lm_slaves = [l for l in lm_live if l > 0]
    # per dispatched round of a cluster: one launch per layer for each member
    # step (all members in one launch), one per layer for the teacher forward
    # of a slave under KD, one per layer for the round's evaluation; then
    # one forward each of the master and every slave for the KD report
    want_flash = sum(R * L * (steps + 1 + (1 if l > 0 else 0))
                     for l in lm_live) + L * (1 + len(lm_slaves))
    want = {"fedagg": R * len(lm_live), "distill": len(lm_slaves),
            "flash": want_flash}
    if lm_launches != want:
        raise AssertionError(f"LM path launches {lm_launches}, expected "
                             f"{want}")
    check_finite(torch, lm, lm.block_losses, lm_kd)
    emit({"phase": "lm_main", "config": "olmo-1b", "cut": lm_cut,
          "d_model": lm_base.d_model, "heads": [lm_base.n_heads,
                                                lm_base.n_kv_heads],
          "head_dim": hd, "d_ff": lm_base.d_ff,
          "vocab": [lm_base.vocab_size, lm_base.padded_vocab],
          "norm": lm_base.norm_type, "k_optimal": lm.k_optimal, "m": lm.m,
          "params_per_level": {str(l): n for l, n in lm_sizes.items()},
          "members": {str(l): len(v) for l, v in lm_members.items()},
          "capacity_and_d_pad": {str(l): list(v)
                                 for l, v in lm_shapes.items()},
          "round_member_losses": lm.block_losses,
          "neg_loss_curves": {str(l): h for l, h in lres.history.items()},
          "slave_kd_loss_vs_master": {str(l): v for l, v in lm_kd.items()},
          "corpus_seconds": corpus_s, "train_seconds_cold": lm_train_s,
          "main_seconds": lm_main_s, "peak_mem_bytes": lm_peak,
          "launches": lm_launches, "expected_launches": want})

    # 7b. the same LM training warm, and traced; and the host's share:
    # each train() draws every level's initial weights on the host and
    # moves them into a plane on the card
    init_s = {}
    for l in lm_live:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plane = lm.plane_of(l, lm.init_params(l))
        torch.cuda.synchronize()
        init_s[str(l)] = time.perf_counter() - t0
        del plane
    emit(dict({"phase": "lm_profile", "init_and_plane_seconds": init_s},
              **profile_train(torch, lm, ltest, ("fedagg", "flash"))))
    del lm
    torch.cuda.empty_cache()

    # 8. LM card == CPU ---------------------------------------------------
    small = dict(name="matrix-lm", family="dense", n_layers=2, d_model=32,
                 n_heads=4, n_kv_heads=4, head_dim=8, d_ff=64, vocab_size=64,
                 rope_theta=1e4, attn_impl="pallas")
    lm_parity = {}
    for variant, kv in (("mha", 4), ("gqa", 2)):
        base = ModelConfig(**dict(small, n_kv_heads=kv))
        finals, inits, runs = {}, {}, {}
        for where in ("cpu", "cuda"):
            sp, scd, stest = lm_federation(8, 64, 8_000, 17, 0)
            e = TokenFedRAC(sp, scd, lm_family(base, 0.5),
                            srv.FLConfig(rounds=2, rounds_per_dispatch=2,
                                         steps_per_round=3, lr=0.05,
                                         local_batch=4, compact_to=2,
                                         class_balanced=False, seed=0),
                            classes=64, device=where).setup()
            inits[where] = {l: e.plane_of(l, e.init_params(l)).cpu()
                            for l in range(e.m)}
            zero_counts()
            runs[where] = e.train(stest).history
            runs[where + "_flash_launches"] = \
                a_ops.flash_attention_bh.launches
            finals[where] = {l: e.plane_of(l, p).cpu()
                             for l, p in e.cluster_params.items()}
        if not (runs["cuda_flash_launches"] > 0
                and runs["cpu_flash_launches"] == 0):
            raise AssertionError(f"LM parity: flash launches {runs}")
        levels = {}
        for l in finals["cpu"]:
            diff = (finals["cuda"][l] - finals["cpu"][l]).abs()
            allowed = LM_PARITY_ATOL + LM_PARITY_RTOL * finals["cpu"][l].abs()
            levels[str(l)] = {"max_abs_diff": float(diff.max()),
                              "worst_share_of_tolerance":
                                  float((diff / allowed).max())}
        lm_parity[variant] = {"levels": levels, "neg_loss": runs}
        emit({"phase": "lm_parity", "variant": variant,
              "tolerance": {"rtol": LM_PARITY_RTOL, "atol": LM_PARITY_ATOL},
              **lm_parity[variant]})
        for l in finals["cpu"]:
            torch.testing.assert_close(inits["cuda"][l], inits["cpu"][l],
                                       rtol=0, atol=0)
            torch.testing.assert_close(finals["cuda"][l], finals["cpu"][l],
                                       rtol=LM_PARITY_RTOL,
                                       atol=LM_PARITY_ATOL)

    # 9. the Table II clustering methods, card == CPU ---------------------
    from repro_torch.core import baselines as bl, clustering as clu
    from repro_torch.core import resources as res_mod
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.models import cnn as cnn_mod
    from repro_torch.sim import fleet as fleet_mod
    from repro_torch.sim import (FleetSim, FleetSimConfig, make_fleet_trace,
                                 sample_profiles)
    t2 = {w: table2_sweep(clu, res_mod, w) for w in ("cuda", "cpu")}
    for method in t2["cpu"]:
        for f in ("di", "labels", "best_k"):
            if t2["cuda"][method][f] != t2["cpu"][method][f]:
                raise AssertionError(f"table2 {method}: {f} on the card "
                                     f"{t2['cuda'][method][f]} != CPU "
                                     f"{t2['cpu'][method][f]}")
    emit({"phase": "table2", "table": "TABLE_III", "lam": "LAMBDA_PAPER",
          "k": [2, 6], "kmeans": "seed 3, one restart, Lloyd loop on the "
          "card (and on the CPU to compare)", "dbscan_optics": "host numpy",
          "best_k": {m: r["best_k"] for m, r in t2["cuda"].items()},
          "di": {m: r["di"] for m, r in t2["cuda"].items()},
          "seconds": {w: {m: r["seconds"] for m, r in t2[w].items()}
                      for w in t2},
          "card_equals_cpu": True})

    # 10. the fleet simulator at 10^6 participants ------------------------
    import resource
    zero_counts()
    n_fleet = 1_000_000
    fleet_cfg = dict(rounds=8, mar_policy="buffer", select="fedcs",
                     lam=res_mod.LAMBDA_PAPER, seed=3)
    t0 = time.perf_counter()
    V_fleet = sample_profiles(n_fleet, seed=3)
    fleet_trace = make_fleet_trace("mixed", n_fleet, 8, seed=3)
    data_s = time.perf_counter() - t0
    clu_s = []
    real_foc = fleet_mod.fleet_optimal_clusters

    def timed_foc(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_foc(*a, **kw)
        torch.cuda.synchronize()
        clu_s.append(time.perf_counter() - t)
        return out

    fleet_mod.fleet_optimal_clusters = timed_foc
    fleet_out = {}
    try:
        for mode in ("sync", "async"):
            t0 = time.perf_counter()
            fsim = FleetSim(res_mod.Fleet.from_matrix(V_fleet.copy()),
                            fleet_trace,
                            FleetSimConfig(mode=mode, **fleet_cfg),
                            device="cuda")
            setup_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            frep = fsim.run()
            run_s = time.perf_counter() - t0
            for row in frep.rows:
                slots = int((row.active + row.masked + row.dropped
                             + row.offline + row.unselected
                             + row.banked).sum())
                if slots != n_fleet:
                    raise AssertionError(f"fleet {mode} round {row.round}: "
                                         f"{slots} of {n_fleet} slots")
            fsum = frep.summary()
            fleet_out[mode] = {
                "setup_seconds": setup_s,
                "fleet_optimal_clusters_seconds": clu_s[-1],
                "rounds_seconds": run_s, "k": frep.k,
                "cluster_sizes": fsum["cluster_sizes"], "mar": frep.mar,
                "di_values": {str(k): v
                              for k, v in frep.di_values.items()},
                "summary": fsum}
            del fsim, frep
    finally:
        fleet_mod.fleet_optimal_clusters = real_foc
    if not (fleet_out["async"]["summary"]["wall_clock_s"]
            <= fleet_out["sync"]["summary"]["wall_clock_s"]):
        raise AssertionError(f"fleet: async wall clock above sync's: "
                             f"{fleet_out}")
    fleet_launches = read_counts()
    if any(fleet_launches.values()):
        raise AssertionError(f"the fleet path launched {fleet_launches}")
    # the Lloyd loop on the CPU for the same fleet: k and how many labels
    # differ (reported; fp32 rounding may move a boundary row)
    cl_card = real_foc(V_fleet, res_mod.LAMBDA_PAPER, seed=3, device="cuda")
    cl_cpu = real_foc(V_fleet, res_mod.LAMBDA_PAPER, seed=3, device="cpu")
    n_resume = 100_000
    ctrl, resumed, resume_s = fleet_resume(
        n_resume, ROOT / "build" / "chip_smoke" / "fleet_resume",
        fleet_cfg, "cuda")
    if resumed != ctrl:
        raise AssertionError("fleet resume at 10^5: rows, summary or levels "
                             "differ from the uninterrupted run")
    emit({"phase": "fleet", "n": n_fleet, "config": dict(
              fleet_cfg, lam=list(res_mod.LAMBDA_PAPER),
              profiles="sample_profiles(n, seed=3)",
              trace="make_fleet_trace('mixed', n, 8, seed=3)"),
          "device_work": "the Lloyd loop of fleet_optimal_clusters' k-means "
                         "(4096-row fit sample) only; the rest is host "
                         "numpy", "data_seconds": data_s, "modes": fleet_out,
          "slots_conserved_every_round": True,
          "async_wall_clock_le_sync": True, "launches": fleet_launches,
          "lloyd_card_vs_cpu": {
              "k": [cl_card.k, cl_cpu.k],
              "labels_differing": int((cl_card.labels
                                       != cl_cpu.labels).sum())},
          "resume": {"n": n_resume, "kill_at_round": 5, "ckpt_every": 2,
                     "bit_identical": True, "seconds": resume_s},
          "peak_rss_bytes": resource.getrusage(
              resource.RUSAGE_SELF).ru_maxrss * 1024})
    del V_fleet, fleet_trace, cl_card, cl_cpu, ctrl, resumed

    # 11. the paper's comparison path: Fed-RAC and the four baselines ------
    ex = load_example("torch_fedrac_cnn_full")
    pargs = ex.parse_args(["--rounds", "4", "--device", "cuda"])
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    zero_counts()
    t0 = time.perf_counter()
    pparts, pcd, ptest, pshape, pclasses = ex.federation(pargs)
    peng = ex.fedrac_engine(pargs, pparts, pcd, pshape, pclasses)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pres = peng.train(ptest)
    torch.cuda.synchronize()
    fedrac_s = time.perf_counter() - t0
    marks = []
    real_eval = bl._eval

    def timed_eval(*a):
        out = real_eval(*a)            # float() of the accuracy: synchronous
        marks.append(time.perf_counter())
        return out

    bl._eval = timed_eval
    paper_bl = {}
    try:
        for name in ex.BASELINES:
            marks.clear()
            t0 = time.perf_counter()
            bparams, hist = ex.run_baseline(name, pargs, pparts, pcd, ptest,
                                            pshape, pclasses)
            per_round = [b - a for a, b in zip([t0] + marks, marks)]
            if len(per_round) != pargs.rounds:
                raise AssertionError(f"{name}: {len(per_round)} rounds timed")
            for x in tree_leaves(bparams):
                if x.device.type != "cuda" or not bool(torch.isfinite(x).all()):
                    raise AssertionError(f"{name}: a parameter is not finite "
                                         "or not on the card")
            paper_bl[name] = {"accuracy": hist,
                              "round_seconds": per_round,
                              "cold_round_seconds": per_round[0],
                              "warm_round_seconds":
                                  sum(per_round[1:]) / (len(per_round) - 1)}
            del bparams
    finally:
        bl._eval = real_eval
    paper_launches = read_counts()
    plive = [l for l in range(peng.m) if peng.assignment.members.get(l)]
    # the example's FLConfig takes the one-round path (rounds_per_dispatch
    # 1): a pytree FedAvg and the autograd KD loss, no kernel; on the
    # dispatch path fedagg would run once per round of each live cluster
    R_disp = peng.cfg.rounds_per_dispatch
    want_paper = {"fedagg": (peng.cfg.rounds * len(plive) if R_disp > 1
                             else 0), "distill": 0, "flash": 0}
    if paper_launches != want_paper:
        raise AssertionError(f"paper path launches {paper_launches}, "
                             f"expected {want_paper}")
    for l, p in list(peng.cluster_params.items()) + [
            ("master", peng.master_params)]:
        for x in tree_leaves(p):
            if x.device.type != "cuda" or not bool(torch.isfinite(x).all()):
                raise AssertionError(f"Fed-RAC level {l}: a parameter is not "
                                     "finite or not on the card")
    emit({"phase": "paper", "example": "examples/torch_fedrac_cnn_full.py",
          "config": {"dataset": pargs.dataset, "samples": pargs.samples,
                     "participants": 40, "seed": pargs.seed,
                     "fedrac": "cnn_family() (base width 0.25), compact_to "
                               "4, rounds_per_dispatch 1",
                     "baselines": "lr 0.08, 4 steps of 16 a round; FedAvg, "
                                  "FedProx, Oort at base width 0.25*0.125, "
                                  "HeteroFL at 0.25 on 3 levels"},
          "cut": {"rounds": f"{pargs.rounds} of 12",
                  "weights": "random, seeded",
                  "data": "synth-mnist (synthetic)"},
          "k_optimal": peng.k_optimal, "m": peng.m,
          "members": {str(l): len(v)
                      for l, v in peng.assignment.members.items()},
          "fedrac_history": {str(l): h for l, h in pres.history.items()},
          "fedrac_final_acc": {str(l): a for l, a in pres.final_acc.items()},
          "fedrac_global_acc": pres.global_acc,
          "setup_seconds": setup_s, "fedrac_train_seconds": fedrac_s,
          "baselines": paper_bl, "launches": paper_launches,
          "expected_launches": want_paper,
          # the peak counts what earlier phases still hold on the card
          "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "held_before_bytes": held_before})
    del peng, pres, pcd
    torch.cuda.empty_cache()

    # 12. the baselines, card == CPU ----------------------------------------
    torch.backends.cudnn.deterministic = True
    bparts, bcd, btest = federation(8, 600, 3)
    bcfg = bl.BaselineConfig(rounds=3, steps_per_round=2, local_batch=8,
                             lr=0.08, seed=3)
    binit = cnn_mod.init_params(torch.Generator().manual_seed(0),
                                base_width=0.25 * 0.125)
    hinit = cnn_mod.init_params(torch.Generator().manual_seed(3),
                                base_width=0.125)
    bruns = {w: baseline_runs(bl, ex.loss_fn, tree_map, bparts, bcd, btest,
                              w, bcfg, binit, hinit)
             for w in ("cpu", "cuda")}
    if bruns["cuda"]["oort_chosen"] != bruns["cpu"]["oort_chosen"]:
        raise AssertionError(f"Oort chose {bruns['cuda']['oort_chosen']} on "
                             f"the card, {bruns['cpu']['oort_chosen']} on "
                             "the CPU")
    bpar = {}
    for name in ("fedavg", "fedprox", "oort", "heterofl"):
        share = 0.0
        for a, b in zip(tree_leaves(bruns["cuda"][name][0]),
                        tree_leaves(bruns["cpu"][name][0])):
            torch.testing.assert_close(a, b, rtol=PARITY_RTOL,
                                       atol=PARITY_ATOL)
            share = max(share, float(((a - b).abs() / (
                PARITY_ATOL + PARITY_RTOL * b.abs())).max()))
        bpar[name] = {"worst_share_of_tolerance": share,
                      "accuracy": {w: bruns[w][name][1] for w in bruns}}
    emit({"phase": "baselines_parity", "tolerance": {"rtol": PARITY_RTOL,
                                                     "atol": PARITY_ATOL},
          "config": "8 participants, 600 samples, 3 rounds of 2 steps of "
                    "8; base width 0.25*0.125 (HeteroFL 0.125); "
                    "deterministic cuDNN",
          "oort_chosen_equal": True,
          "oort_chosen": bruns["cuda"]["oort_chosen"], "baselines": bpar})
    del bruns

    # 13. the examples as processes on the card, side by side -------------
    def run_example(name):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable,
                               str(ROOT / "examples" / f"{name}.py")],
                              capture_output=True, text=True, timeout=600,
                              env=env, cwd=ROOT)
        if proc.returncode != 0:
            raise AssertionError(f"{name} exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        return name, {"seconds": time.perf_counter() - t0,
                      "exit_code": proc.returncode,
                      "last_lines": proc.stdout.strip().splitlines()[-3:]}

    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(3) as pool:
        # phase 19 (the LM example) runs beside them, for the time limit
        lm_ex = pool.submit(phase_lm_example, env)
        ex_runs = dict(pool.map(run_example,
                                ("torch_quickstart", "torch_fedrac_sim")))
        lm_ex.result()
    emit({"phase": "examples", "device": "cuda (the examples' default)",
          "concurrent": "the two processes share the card, and with "
                        "lm_example's: seconds overlap", "runs": ex_runs})

    # 14. Fed-RAC on the MoE family, granite-moe-1b-a400m width ------------
    import numpy as np
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import encdec as encdec_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import registry as reg_mod
    from repro_torch.models import transformer as tf_mod
    from repro_torch.core.plane import make_plane_spec
    from repro_torch.sim.faults import corrupt_checkpoint
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    mres = meng.train(mtest)
    torch.cuda.synchronize()
    moe_train_s = time.perf_counter() - t0
    moe_block_losses = list(meng.block_losses)
    mt = torch.as_tensor(mtest["tokens"], device=dev)
    moe_kd = {}
    with torch.no_grad():
        _, t_logits = meng.family.loss_and_logits(0, meng.master_params,
                                                  {"tokens": mt})
        for level, p in meng.cluster_params.items():
            if level == 0:
                continue
            _, s_logits = meng.family.loss_and_logits(level, p,
                                                      {"tokens": mt})
            moe_kd[level] = float(distill.kd_loss(
                s_logits, mt[:, -1], t_logits, T=lm_cfg.kd_T,
                alpha=lm_cfg.kd_alpha, use_kernel=True))
    torch.cuda.synchronize()
    moe_main_s = time.perf_counter() - t0
    moe_peak = torch.cuda.max_memory_allocated()
    moe_launches = read_counts()
    L = moe_base.n_layers
    moe_slaves = [l for l in moe_live if l > 0]
    # as lm_main: per dispatched round one flash launch per layer for each
    # member step, the slave's teacher forward and the evaluation; then
    # the KD report's forwards
    want = {"fedagg": R * len(moe_live), "distill": len(moe_slaves),
            "flash": sum(R * L * (steps + 1 + (1 if l > 0 else 0))
                         for l in moe_live) + L * (1 + len(moe_slaves))}
    if moe_launches != want:
        raise AssertionError(f"MoE path launches {moe_launches}, expected "
                             f"{want}")
    check_finite(torch, meng, meng.block_losses, moe_kd)
    with torch.no_grad():                 # after the counts are read
        cfg0 = compress_config(moe_base, 0.5, 0)
        _, moe_aux = tf_mod.forward(cfg0, meng.master_params, mt)
        moe_kept = first_moe_kept(torch, cfg0, meng.master_params, mt)
    t0 = time.perf_counter()
    meng.train(mtest)
    torch.cuda.synchronize()
    moe_warm_s = time.perf_counter() - t0
    emit({"phase": "moe_main", "config": MOE_ARCH,
          "cut": dict(lm_cut, n_layers="2 of 24"),
          "d_model": moe_base.d_model,
          "heads": [moe_base.n_heads, moe_base.n_kv_heads],
          "head_dim": moe_base.head_dim, "d_ff": moe_base.d_ff,
          "experts": [moe_base.n_experts, moe_base.experts_per_tok],
          "dispatch": {"impl": moe_base.moe_impl,
                       "group": moe_base.moe_group,
                       "capacity_factor": moe_base.moe_capacity},
          "vocab": [moe_base.vocab_size, moe_base.padded_vocab],
          "k_optimal": meng.k_optimal, "m": meng.m,
          "params_per_level": {
              str(l): param_count(compress_config(moe_base, 0.5, l))
              for l in range(3)},
          "experts_per_level": {
              str(l): compress_config(moe_base, 0.5, l).n_experts
              for l in range(3)},
          "members": {str(l): len(v) for l, v in moe_members.items()},
          "capacity_and_d_pad": {str(l): list(v)
                                 for l, v in moe_shapes.items()},
          "round_member_losses": meng.block_losses,
          "neg_loss_curves": {str(l): h for l, h in mres.history.items()},
          "slave_kd_loss_vs_master": {str(l): v for l, v in moe_kd.items()},
          "master_router_aux": float(moe_aux),
          "master_first_block_kept_of_made": list(moe_kept),
          "train_seconds_cold": moe_train_s,
          "train_seconds_warm": moe_warm_s, "main_seconds": moe_main_s,
          "peak_mem_bytes": moe_peak, "launches": moe_launches,
          "expected_launches": want})
    del meng
    torch.cuda.empty_cache()

    # 14b. the grouped GEMM kernels and the granite cell's main path -------
    gg_cases, gg_main = phase_grouped_gemm(torch, dev)

    # 15. the MoE federation, card == CPU ---------------------------------
    mbase = ModelConfig(**MOE_SMALL)
    finals, inits, runs = {}, {}, {}
    for where in ("cpu", "cuda"):
        sp, scd, stest = lm_federation(8, 64, 8_000, 17, 0)
        e = TokenFedRAC(sp, scd, lm_family(mbase, 0.5),
                        srv.FLConfig(rounds=2, rounds_per_dispatch=2,
                                     steps_per_round=3, lr=0.05,
                                     local_batch=4, compact_to=2,
                                     class_balanced=False, seed=0),
                        classes=64, device=where).setup()
        inits[where] = {l: e.plane_of(l, e.init_params(l)).cpu()
                        for l in range(e.m)}
        zero_counts()
        runs[where] = e.train(stest).history
        runs[where + "_launches"] = read_counts()
        finals[where] = {l: e.plane_of(l, p).cpu()
                         for l, p in e.cluster_params.items()}
        toks = torch.as_tensor(scd[0]["tokens"][:4], device=where)
        runs[where + "_master_kept_of_made"] = list(first_moe_kept(
            torch, mbase, e.params_of(0, e.plane_of(0, e.init_params(0))),
            toks))
    kept, made = runs["cpu_master_kept_of_made"]
    if not kept < made:
        raise AssertionError(f"moe_parity: no token dropped ({kept} of "
                             f"{made} choices kept)")
    if not (runs["cuda_launches"]["flash"] > 0
            and runs["cpu_launches"]["flash"] == 0):
        raise AssertionError(f"moe_parity: launches {runs}")
    levels = {}
    for l in finals["cpu"]:
        diff = (finals["cuda"][l] - finals["cpu"][l]).abs()
        allowed = LM_PARITY_ATOL + LM_PARITY_RTOL * finals["cpu"][l].abs()
        levels[str(l)] = {"max_abs_diff": float(diff.max()),
                          "worst_share_of_tolerance":
                              float((diff / allowed).max())}
    emit({"phase": "moe_parity",
          "tolerance": {"rtol": LM_PARITY_RTOL, "atol": LM_PARITY_ATOL},
          "config": MOE_SMALL, "levels": levels, "runs": runs})
    for l in finals["cpu"]:
        torch.testing.assert_close(inits["cuda"][l], inits["cpu"][l],
                                   rtol=0, atol=0)
        torch.testing.assert_close(finals["cuda"][l], finals["cpu"][l],
                                   rtol=LM_PARITY_RTOL, atol=LM_PARITY_ATOL)

    # 16. every new mixer at full width, prefill == decode ----------------
    zero_counts()
    families = {}
    for arch, cut, hold in FAMILIES:
        full = get_config(arch).replace(**cut)
        smoke = get_config(arch, smoke=True)
        if full.n_experts:
            # capacity E/K: a group's every token fits its expert, so no
            # choice drops and the prefill and one-token decode steps
            # compute the same function; the smoke runs the same dispatch
            full = full.replace(moe_capacity=full.n_experts
                                / full.experts_per_tok)
            smoke = smoke.replace(moe_impl="capacity",
                                  moe_capacity=smoke.n_experts
                                  / smoke.experts_per_tok)
        ref32 = prefill_vs_decode(torch, reg_mod, encdec_mod, moe_mod, smoke,
                                  torch.device("cpu"), FAMILY_B, SMOKE_S,
                                  0)[0]
        tol = BF16_OVER_FP32_EPS * max(ref32["relative_gap"], 2.0 ** -24)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        r, gaps, after_flip, _ = prefill_vs_decode(
            torch, reg_mod, encdec_mod, moe_mod, full, dev, FAMILY_B,
            FAMILY_S, 0)
        over = gaps > tol
        r.update(peak_mem_bytes=torch.cuda.max_memory_allocated(),
                 held_before_bytes=held, dtype=full.dtype,
                 layers=[full.n_layers, full.n_enc_layers]
                 if reg_mod.is_encdec(full) else full.n_layers,
                 mixers=list(full.block_pattern),
                 ffn=list(full.ffn_pattern),
                 smoke_fp32_cpu=ref32, tolerance_relative=tol,
                 positions=gaps.numel(),
                 positions_over_tolerance=int(over.sum()),
                 positions_after_a_router_flip=int(after_flip.sum()),
                 largest_gap_before_any_flip=float(
                     gaps[~after_flip].max()) if (~after_flip).any()
                 else None)
        families[arch] = r
        emit({"phase": "families", "arch": arch, "held_in": hold, **r})
        if not r["finite"]:
            raise AssertionError(f"{arch}: non-finite logits")
        if hold == "bf16" and (over & ~after_flip).any():
            # every position within the tolerance, except those at or
            # after a top-k flip of the router in their sequence
            raise AssertionError(f"{arch}: prefill vs decode beyond the "
                                 f"tolerance {tol} before any router flip")
        if hold == "fp32":
            # the same model in fp32: the decode may differ from the
            # prefill by what rounding moves the prefill itself, 16 times
            # the response to a one-ulp nudge (its running maximum along
            # the sequence), and at least by the smoke's fp32 gap
            torch.cuda.empty_cache()
            r32, gaps32, _, resp = prefill_vs_decode(
                torch, reg_mod, encdec_mod, moe_mod,
                full.replace(dtype="float32"), dev, FAMILY_B, FAMILY_S, 0,
                nudge=True)
            allowed = 16 * torch.clamp(resp.cummax(dim=1)[0],
                                       min=ref32["relative_gap"])
            r32.update(nudge_response_max=float(resp.max()),
                       worst_share_of_allowed=float((gaps32 / allowed).max()))
            emit({"phase": "families", "arch": arch, "dtype": "float32",
                  **r32})
            if not (r32["finite"] and (gaps32 <= allowed).all()):
                raise AssertionError(f"{arch}: fp32 prefill vs decode beyond "
                                     "16 times the nudge response")
        torch.cuda.empty_cache()
    fam_launches = read_counts()
    if any(fam_launches.values()):
        raise AssertionError(f"families launched {fam_launches}")

    # 17. serving: repro_torch.launch.serve on granite, full width and depth
    serve_dir = ROOT / "build" / "chip_smoke" / "serve"
    shutil.rmtree(serve_dir, ignore_errors=True)
    serve_dir.mkdir(parents=True)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    stdout = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        toks = serve_mod.main(SERVE_ARGS + [
            "--metrics-json", str(serve_dir / "metrics.json")])
    serve_s = time.perf_counter() - t0
    serve_peak = torch.cuda.max_memory_allocated()
    metrics = json.loads((serve_dir / "metrics.json").read_text())
    scfg = get_config(MOE_ARCH)
    shape = tuple(int(SERVE_ARGS[SERVE_ARGS.index(f) + 1])
                  for f in ("--batch", "--gen"))
    if toks.shape != shape or not ((0 <= toks) & (toks < scfg.vocab_size)
                                   ).all():
        raise AssertionError(f"serve: tokens {toks.shape} outside the "
                             "vocabulary")
    # the watched directory: a valid plane of the served model (other
    # weights: seed 1), a newer corrupt step, a newest of another shape
    ck = serve_dir / "ckpt"
    key = f"plane/{WATCH_LEVEL}"
    hdr = {"run_state": {"version": 1, "kind": "hetero-sim"}}
    mgr = CheckpointManager(str(ck), keep=10)
    wcfg = compress_config(scfg, 0.5, WATCH_LEVEL)
    t0 = time.perf_counter()
    reloaded = reg_mod.init_params(
        wcfg, torch.Generator(device=dev).manual_seed(1))
    spec = make_plane_spec(reloaded)
    watch_params = reg_mod.param_count(reloaded)
    mgr.save(1, hdr, {key: spec.to_plane(reloaded).cpu().numpy()})
    write_s = time.perf_counter() - t0
    mgr.save(2, hdr, {key: np.zeros(4096, np.float32)})
    corrupt_checkpoint(str(ck), "garbage")
    mgr.save(3, hdr, {key: np.zeros(4096, np.float32)})
    seen = []

    class Watcher(serve_mod.PlaneWatcher):
        def poll(self, params):
            out, fresh = super().poll(params)
            if fresh:
                seen.append((self.step, [x.dtype for x in
                                         tree_leaves(out)],
                             all(torch.equal(a, b) for a, b in zip(
                                 tree_leaves(out), tree_leaves(reloaded)))))
            return out, fresh

    lines = LogLines()
    logging.getLogger("repro_torch.serve").addHandler(lines)
    serve_mod.PlaneWatcher = Watcher
    stdout_w = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(stdout_w):
            serve_mod.main(SERVE_ARGS + [
                "--cluster-level", str(WATCH_LEVEL), "--watch-level",
                str(WATCH_LEVEL), "--watch-ckpt", str(ck),
                "--metrics-json", str(serve_dir / "watch_metrics.json")])
    finally:
        serve_mod.PlaneWatcher = Watcher.__mro__[1]
        logging.getLogger("repro_torch.serve").removeHandler(lines)
    watch_s = time.perf_counter() - t0
    serve_launches = read_counts()
    del reloaded
    wm = json.loads((serve_dir / "watch_metrics.json").read_text())
    skipped = sorted({int(l.split("step ")[1].split()[0].rstrip(":"))
                      for l in lines.lines})
    watch = {"reloads": wm["counters"].get("serve/plane_reloads"),
             "plane_step": wm["gauges"].get("serve/plane_step"),
             "skipped_steps": skipped, "warnings": lines.lines,
             "reloaded": [{"step": st, "dtypes": sorted({str(d) for d in ds}),
                           "equal_to_the_plane's_model": eq}
                          for st, ds, eq in seen],
             "level": WATCH_LEVEL, "plane_floats": spec.d_pad,
             "params": watch_params,
             "plane_write_seconds": write_s, "seconds": watch_s,
             "stdout": stdout_w.getvalue().splitlines()[:3]}
    if not (watch["reloads"] == 1 and watch["plane_step"] == 1
            and skipped == [2, 3] and len(seen) == 1
            and watch["reloaded"][0]["dtypes"] == [str(getattr(torch,
                                                               scfg.dtype))]
            and seen[0][2]
            and "# serving plane from checkpoint step 1"
            in stdout_w.getvalue()):
        raise AssertionError(f"serve --watch-ckpt: {watch}")
    if any(serve_launches.values()):
        raise AssertionError(f"serve launched {serve_launches}")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable,
                           str(ROOT / "examples" / "torch_serve_demo.py")],
                          capture_output=True, text=True, timeout=600,
                          env=env, cwd=ROOT)
    demo = {"seconds": time.perf_counter() - t0,
            "exit_code": proc.returncode,
            "last_lines": proc.stdout.strip().splitlines()[-3:]}
    if proc.returncode != 0:
        raise AssertionError(f"torch_serve_demo exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    hist = metrics["histograms"]["serve/decode_step_s"]
    emit({"phase": "serve", "argv": SERVE_ARGS, "dtype": scfg.dtype,
          "layers": scfg.n_layers, "seconds": serve_s,
          "tokens_per_second": metrics["gauges"]["serve/decode_tok_per_s"],
          "seconds_per_decode_step": hist["sum"] / hist["count"],
          "counters": metrics["counters"], "gauges": metrics["gauges"],
          "stdout": stdout.getvalue().splitlines()[:2],
          "peak_mem_bytes": serve_peak, "launches": serve_launches,
          "watch": watch, "demo": demo})

    # 18-20. LM pretraining, the LM example, the mesh path --------------
    train_launches = phase_train(torch, dev, env, zero_counts,
                                 read_counts)
    uns_launches, mesh_launches, tp_state = phase_mesh(
        torch, dev, env, n_test, zero_counts)
    # 21. the tensor-parallel member forward ------------------------------
    tp_launches, flash_local = phase_tp(torch, dev, env, tp_state, {
        "block_losses": lm_block_losses, "heads": H, "head_dim": hd,
        "capacity": lm_shapes[0][0]})
    # 22. the tensor-parallel forward of the other families ---------------
    fam_tp_launches, fam_tp_kernels = phase_tp_families(torch, dev, env, {
        "block_losses": moe_block_losses, "peak_mem_bytes": moe_peak,
        "capacity": moe_shapes[0][0], "heads": mH, "kv_heads": mKV,
        "head_dim": mhd})

    # 23. the compile analysis against the card ---------------------------
    dryrun_launches = phase_dryrun(torch, env)

    # kernels line, card line, last line -----------------------------------
    D0 = lm_shapes[0][1]
    fed = fed_timed[(C0, D0)]
    dist = dist_timed[(n_lm_test, V_lm, str(torch.float32))]
    fl = flash_timed["lm_main_member_step"]
    by_path = {k: {"cnn_main": cnn_launches[k], "lm_main": lm_launches[k]}
               for k in cnn_launches}
    by_path["fedagg"]["sim_main"] = sim_runs["cold"]["launches"]["fedagg"]
    by_path["fedagg"]["sim_legacy"] = legacy["launches"]["fedagg"]
    by_path["fedagg"]["async_main"] = async_runs["cold"]["launches"]["fedagg"]
    for k in by_path:
        by_path[k]["fleet"] = fleet_launches[k]
        by_path[k]["paper"] = paper_launches[k]
        by_path[k]["moe_main"] = moe_launches[k]
        by_path[k]["families"] = fam_launches[k]
        by_path[k]["serve"] = serve_launches[k]
        by_path[k]["train"] = train_launches[k]
    by_path["fedagg"]["mesh_unsharded"] = uns_launches
    for shape, per_rank in mesh_launches.items():
        by_path["fedagg"][f"mesh_{shape}_per_rank"] = per_rank
    for k in by_path:
        by_path[k]["tp"] = tp_launches[k]
        by_path[k]["tp_families"] = fam_tp_launches[k]
        by_path[k]["dryrun_world_1x2_per_rank"] = dryrun_launches[k]
    print(json.dumps({"phase_ends_seconds": PHASE_ENDS}), flush=True)
    emit({"kernels": [
        {"name": "fedagg", "route": "cuda",
         "source": "src/repro_torch/kernels/fedagg/csrc/fedagg.cu",
         "replaces": "src/repro/kernels/fedagg/kernel.py:23",
         "shape": [C0, D0], "launches": lm_launches["fedagg"],
         "launches_by_path": by_path["fedagg"],
         "tp_families_rank_blocks": {k: {f: v[f] for f in (
             "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms")}
             for k, v in fam_tp_kernels["fedagg"].items()},
         "wrappers": fed_wrappers,
         "max_abs_err": fed["max_abs_err"], "ms": fed["ms"],
         "plain_ms": fed["plain_ms"], "bound_ms": fed["bound_ms"],
         "bound_by": fed["bound_by"], "library_ms": fed["library_ms"]},
        {"name": "distill", "route": "cuda",
         "source": "src/repro_torch/kernels/distill/csrc/distill.cu",
         "replaces": "src/repro/kernels/distill/kernel.py:83",
         "shape": [n_lm_test, V_lm], "launches": lm_launches["distill"],
         "launches_by_path": by_path["distill"],
         "design": "split vocabulary", "splits": dist["splits"],
         "kernels_per_call": dist["kernels_per_call"],
         "max_abs_err": dist["max_abs_err"], "ms": dist["ms"],
         "plain_ms": dist["plain_ms"], "bound_ms": dist["bound_ms"],
         "bound_by": dist["bound_by"], "library_ms": dist["library_ms"]},
        {"name": "flash", "route": "cuda",
         "source": "src/repro_torch/kernels/flash/csrc/flash.cu",
         "replaces": "src/repro/kernels/flash/kernel.py:68",
         "shape": [fl["bh"], fl["S"], fl["hd"]],
         "launches": lm_launches["flash"],
         "launches_by_path": by_path["flash"], "variant": fl["variant"],
         "tp_local_heads": {k: flash_local[k] for k in (
             "bh", "H", "S", "hd", "max_abs_err", "ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms")},
         "tp_families_local_heads": {k: fam_tp_kernels["flash"][k] for k in (
             "bh", "kv_rows", "H", "S", "hd", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "tensor_cores": fl["route"] == "tc",
         "bound_cuda_core_ms": fl["bound_cuda_core_ms"], "peak": fl["peak"],
         "max_abs_err": fl["max_abs_err"], "ms": fl["ms"],
         "plain_ms": fl["plain_ms"], "bound_ms": fl["bound_ms"],
         "bound_by": fl["bound_by"], "library_ms": fl["library_ms"]},
        {"name": "grouped_gemm", "route": "cuda",
         "source": "src/repro_torch/kernels/grouped_gemm/csrc/grouped_gemm.cu",
         "replaces": None, "cell": GG_CELL,
         "launches": gg_main["grouped_gemm_launches"],
         "launches_by_path": {"granite_cell_main":
                              gg_main["grouped_gemm_launches"]},
         "cases_by_level": {str(l): c for l, c in gg_cases.items()}},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
