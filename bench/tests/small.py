"""The benchmark's cells cut to sizes a CPU test can hold: the same
files, kinds, generator, engine and checks, at small widths, fewer
participants, samples and steps."""
from __future__ import annotations

import copy

from bench import manifest

FL_SMALL = {"rounds": 2, "rounds_per_dispatch": 2, "steps_per_round": 2}


def cnn_cell(name="cnn.paper40_kd"):
    cell = copy.deepcopy(manifest.cell(name))
    cell["config"]["base_width"] = 0.0625
    cell["traffic"].update(pick=12, train_samples=480, test_samples=120)
    cell["traffic"]["fl"].update(FL_SMALL, local_batch=8, compact_to=3)
    return cell


def lm_cell(name="olmo1b.fl14_kd"):
    cell = copy.deepcopy(manifest.cell(name))
    cell["config"].update(d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
                          d_ff=256, vocab_size=512)
    cell["traffic"].update(pick=6, corpus_tokens=3000, seq=32,
                           windows_per_member=8, test_windows=4)
    cell["traffic"]["fl"].update(FL_SMALL, local_batch=2)
    return cell
