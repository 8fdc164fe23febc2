"""The port's checkpoint layer (``repro_torch.ckpt``) against the JAX
package's (``repro.ckpt``).

The port writes the msgpack subset of the checkpoint format itself (no
``msgpack`` on the card's machine): for the same arrays its file is
byte-identical to the JAX package's, and each package restores the other's.
Then the manifest layer (CRC32, atomic rename, keep-K rotation, degrade to
the newest valid checkpoint under each corruption mode), the run-state
header, the strict restore, and the sampler-stream fingerprint, as the JAX
tests hold them (``tests/test_ckpt_resume.py``,
``tests/test_data_optim_ckpt.py``).
"""
import os

import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as j_checkpoint
from repro.ckpt.manifest import CheckpointManager as JCheckpointManager

from repro_torch.ckpt import checkpoint
from repro_torch.ckpt.checkpoint import CheckpointError
from repro_torch.ckpt.manifest import CheckpointManager
from repro_torch.ckpt.run_state import RUN_STATE_VERSION, make_checkpointer
from repro_torch.data import device_sampler
from repro_torch.sim.faults import CORRUPTION_MODES, corrupt_checkpoint

HDR = {"run_state": {"version": RUN_STATE_VERSION, "kind": "hetero-sim"}}


def _families():
    """One array per dtype/shape family a run-state snapshot holds."""
    rng = np.random.default_rng(0)
    return {
        "plane/0": rng.normal(size=2176).astype(np.float32),
        "labels": rng.integers(0, 10, 500).astype(np.int32),
        "fleet/n_data": rng.integers(1, 9999, 1000).astype(np.int64),
        "parts/V": rng.normal(size=(16, 3)),                    # float64
        "rows/active": np.zeros((0, 3), np.int64),              # empty bank
        "online": rng.integers(0, 2, 1000).astype(bool),
    }


def _wide():
    """Every length class of the format: 20 keys (map16), keys past 31 and
    255 bytes (str8, str16), payloads past 255 and 65,535 bytes (bin16,
    bin32), 17 dimensions (array16) and dimensions past 127, 255 and
    65,535 (uint8, uint16, uint32)."""
    rng = np.random.default_rng(1)
    out = {f"k{i:02d}/" + "x" * (i * 14): rng.normal(size=i + 1).astype(
        np.float32) for i in range(20)}
    out["bin32"] = rng.normal(size=20_000).astype(np.float32)
    out["dims17"] = np.zeros((1,) * 17, np.float32)
    out["dim200"] = np.arange(400, dtype=np.int16).reshape(200, 2)
    out["dim70000"] = np.zeros((70_000, 1), np.int8)
    return out


def _nested():
    rng = np.random.default_rng(2)
    return {"b": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                  "n": [np.arange(5, dtype=np.int32),
                        np.float32(2.5)]},
            "a": rng.normal(size=7)}


PAYLOADS = {"families": _families, "wide": _wide, "nested": _nested}


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_file_is_byte_identical_to_jax(tmp_path, name):
    tree = PAYLOADS[name]()
    checkpoint.save(str(tmp_path / "t.ckpt"), tree)
    j_checkpoint.save(str(tmp_path / "j.ckpt"), tree)
    got = (tmp_path / "t.ckpt").read_bytes()
    assert got == (tmp_path / "j.ckpt").read_bytes()
    n_leaves = len(checkpoint.restore(str(tmp_path / "t.ckpt")))
    assert got[0] == (0xDE if name == "wide" else 0x80 | n_leaves)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_restores_the_others_file(tmp_path, writer):
    arrays = dict(_families(), **_wide())
    path = str(tmp_path / "a.ckpt")
    save, restore = ((checkpoint.save, j_checkpoint.restore)
                     if writer == "port"
                     else (j_checkpoint.save, checkpoint.restore))
    save(path, arrays)
    back = restore(path)
    assert set(back) == set(arrays)
    for k, a in arrays.items():
        assert back[k].dtype == a.dtype and back[k].shape == a.shape, k
        np.testing.assert_array_equal(back[k], a, err_msg=k)
        assert back[k].flags.writeable, k


def test_manifest_directories_cross_packages(tmp_path):
    """A manifest directory either package wrote loads in the other, CRCs
    checked: the port's manager writes the same files as JAX's."""
    arrays = _families()
    CheckpointManager(str(tmp_path / "t")).save(3, HDR, arrays)
    JCheckpointManager(str(tmp_path / "j")).save(3, HDR, arrays)
    for fn in ("arrays.ckpt", "meta.json"):
        assert ((tmp_path / "t" / "step_00000003" / fn).read_bytes()
                == (tmp_path / "j" / "step_00000003" / fn).read_bytes())
    for mgr in (CheckpointManager(str(tmp_path / "j")),
                JCheckpointManager(str(tmp_path / "t"))):
        step, meta, back = mgr.load_latest()
        assert step == 3 and meta == HDR
        for k, a in arrays.items():
            np.testing.assert_array_equal(back[k], a, err_msg=k)


def test_manager_roundtrip_every_dtype_family(tmp_path):
    """fp32 planes, int32 label shards, int64 columns, float64 resource
    matrices, bool masks and EMPTY arrays all survive a manifest save/load
    bit-identically, as writable copies; torch tensors save as their
    host arrays."""
    arrays = _families()
    arrays["tensor"] = torch.arange(6, dtype=torch.float32)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"tag": "fam"}, arrays)
    meta, back = mgr.load_step(1)
    assert meta["tag"] == "fam"
    assert set(back) == set(arrays)
    arrays["tensor"] = arrays["tensor"].numpy()
    for k, a in arrays.items():
        assert back[k].dtype == a.dtype and back[k].shape == a.shape, k
        np.testing.assert_array_equal(back[k], a, err_msg=k)
        assert back[k].flags.writeable, k


def test_manager_rotation_keeps_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"r": s}, {"a": np.full(3, s, np.float32)})
    assert mgr.steps() == [3, 4]
    dirs = [d for d in os.listdir(tmp_path) if d.startswith("step_")]
    assert sorted(dirs) == ["step_00000003", "step_00000004"]
    assert mgr.load_latest()[0] == 4
    with pytest.raises(ValueError, match="keep"):
        CheckpointManager(str(tmp_path), keep=0)


@pytest.mark.parametrize("mode", CORRUPTION_MODES)
def test_manager_degrades_to_previous_valid(tmp_path, mode):
    """A corrupted, truncated or deleted NEWEST checkpoint never crashes the
    restore: ``load_latest`` walks back to the previous valid step (for
    manifest damage, the directory scan still finds the intact steps)."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    for s in (1, 2):
        mgr.save(s, {"r": s}, {"a": np.full(4, s, np.float32)})
    corrupt_checkpoint(str(tmp_path), mode)
    got = CheckpointManager(str(tmp_path), keep=3).load_latest()
    assert got is not None, f"[{mode}] no fallback checkpoint found"
    step, meta, arrays = got
    assert step == (2 if mode == "manifest" else 1)
    assert meta == {"r": step}
    np.testing.assert_array_equal(arrays["a"], np.full(4, step, np.float32))
    if mode != "manifest":
        with pytest.raises(CheckpointError):
            mgr.load_step(2)


def test_manager_no_checkpoints(tmp_path):
    assert CheckpointManager(str(tmp_path)).load_latest() is None
    assert CheckpointManager(str(tmp_path / "nonexistent")).steps() == []
    with pytest.raises(FileNotFoundError):
        corrupt_checkpoint(str(tmp_path), "garbage")


def test_run_checkpointer_header_validation(tmp_path):
    """Foreign kinds and incompatible versions are skipped with a warning,
    not loaded into the wrong engine; the cadence starts at ``every``."""
    ck = make_checkpointer(str(tmp_path), every=2)
    assert not ck.due(0) and not ck.due(1) and ck.due(2) and not ck.due(3)
    ck.save(2, "fleet-sim", {"round": 2}, {"a": np.zeros(2, np.float32)})
    assert ck.load_latest("hetero-sim") is None      # kind mismatch
    assert ck.load_latest("fleet-sim")[0] == 2
    bad = dict(HDR, run_state={"version": RUN_STATE_VERSION + 1,
                               "kind": "hetero-sim"})
    ck.manager.save(4, bad, {"a": np.zeros(2, np.float32)})
    assert ck.load_latest("hetero-sim") is None      # version mismatch
    ck.manager.save(6, {"round": 6}, {"a": np.zeros(2, np.float32)})
    assert ck.load_latest("hetero-sim") is None      # no header at all


def test_nested_tree_restores_flat_and_steps(tmp_path):
    """A nested tree comes back as its flat {path: array} map; ``save_step``
    keeps the newest ``keep`` files and ``latest_step`` finds the newest."""
    tree = _nested()
    path = str(tmp_path / "t.ckpt")
    checkpoint.save(path, tree)
    back = checkpoint.restore(path)
    assert list(back) == ["a", "b/n/0", "b/n/1", "b/w"]
    np.testing.assert_array_equal(back["b/w"], tree["b"]["w"])
    np.testing.assert_array_equal(back["b/n/0"], tree["b"]["n"][0])
    assert back["b/n/1"] == np.float32(2.5)
    for s in (1, 2, 3, 4):
        checkpoint.save_step(str(tmp_path / "s"), s, {"w": np.ones(2)},
                             keep=2)
    assert checkpoint.latest_step(str(tmp_path / "s")) == 4
    assert len(os.listdir(tmp_path / "s")) == 2
    assert checkpoint.latest_step(str(tmp_path / "none")) is None


def test_restore_missing_file_raises(tmp_path):
    """A missing file raises ``CheckpointError``, never a bare OSError."""
    with pytest.raises(CheckpointError, match="cannot read"):
        checkpoint.restore(str(tmp_path / "nope.ckpt"))


def _full_file():
    return checkpoint.packb({"a": {"dtype": "float32", "shape": [3],
                                   "data": np.ones(3, np.float32).tobytes()}})


MALFORMED = {
    "truncated": lambda: _full_file()[:len(_full_file()) // 2],
    "extra-bytes": lambda: _full_file() + b"\x00",
    "nil": lambda: b"\xc0",
    "float": lambda: b"\xcb" + bytes(8),
    "not-a-map": lambda: checkpoint.packb([1, 2]),
    "int-key": lambda: b"\x81\x01\x01",
    "short-leaf": lambda: checkpoint.packb(
        {"a": {"dtype": "float32", "shape": [2], "data": b"1234"}}),
    "bad-dtype": lambda: checkpoint.packb(
        {"a": {"dtype": "nonsense", "shape": [1], "data": b""}}),
    "not-a-record": lambda: checkpoint.packb({"a": 7}),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_file_raises_checkpoint_error(tmp_path, case):
    """Every malformed file — a torn write, trailing bytes, a type outside
    the format, a record whose byte count does not match its dtype and
    shape — raises ``CheckpointError``."""
    (tmp_path / "bad.ckpt").write_bytes(MALFORMED[case]())
    with pytest.raises(CheckpointError):
        checkpoint.restore(str(tmp_path / "bad.ckpt"))


def test_restored_arrays_are_writable(tmp_path):
    """Restored leaves are independently owned WRITABLE copies, not
    read-only views of the file's bytes."""
    tree = {"a": np.arange(6, dtype=np.float32),
            "n": {"b": np.ones((2, 3), dtype=np.int64)}}
    path = str(tmp_path / "t.ckpt")
    checkpoint.save(path, tree)
    for arr in checkpoint.restore(path).values():
        assert arr.flags.writeable
        arr[(0,) * arr.ndim] = 42                    # must not raise


def test_sampler_stream_fingerprint():
    """The resume integrity probe: equal (seed, round) → equal fingerprint,
    another seed or round → another; and the port's stream is not JAX's,
    so neither is its fingerprint (a JAX run-state checkpoint fails the
    port's check)."""
    from repro.data import device_sampler as j_sampler
    a = device_sampler.stream_fingerprint(3, 7)
    assert a == device_sampler.stream_fingerprint(3, 7)
    assert a != device_sampler.stream_fingerprint(4, 7)
    assert a != device_sampler.stream_fingerprint(3, 8)
    assert 0 <= a < 1 << 32
    assert a != j_sampler.stream_fingerprint(3, 7)
