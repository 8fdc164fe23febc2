"""bf16 leaves in the port's checkpoint format, against the JAX package's.

JAX writes a ``jnp.bfloat16`` leaf as its raw 2-byte words under the dtype
string ``"bfloat16"``; the port writes a ``torch.bfloat16`` tensor (or an
``ml_dtypes`` bf16 array) the same way, so the two files of one tree are
byte-identical, and each package restores the other's.  The port reads a
bf16 leaf without ``ml_dtypes``, into a CPU ``torch.bfloat16`` tensor, also
in a process that imports neither JAX nor ``ml_dtypes``.
"""
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as j_checkpoint

from repro_torch.ckpt import checkpoint
from repro_torch.ckpt.checkpoint import CheckpointError
from repro_torch.ckpt.manifest import CheckpointManager

REPO = pathlib.Path(__file__).resolve().parents[1]


def _values():
    rng = np.random.default_rng(5)
    return {"w": rng.normal(size=(3, 5)).astype(np.float32),
            "emb": rng.normal(size=(300, 7)).astype(np.float32),
            "empty": np.zeros((0, 4), np.float32),
            "scale": np.float32(-1.5e-3)}


def _trees():
    """One tree in both packages: bf16 leaves beside fp32 and int32."""
    v = _values()
    jt = {"blocks": {"w": jnp.asarray(v["w"], jnp.bfloat16),
                     "emb": jnp.asarray(v["emb"], jnp.bfloat16)},
          "empty": jnp.asarray(v["empty"], jnp.bfloat16),
          "scale": jnp.asarray(v["scale"], jnp.bfloat16),
          "fp32": jnp.asarray(v["w"]), "ids": jnp.arange(6, dtype=jnp.int32)}
    tt = {"blocks": {"w": torch.tensor(v["w"]).to(torch.bfloat16),
                     "emb": torch.tensor(v["emb"]).to(torch.bfloat16)},
          "empty": torch.tensor(v["empty"]).to(torch.bfloat16),
          "scale": torch.tensor(v["scale"]).to(torch.bfloat16),
          "fp32": torch.tensor(v["w"]),
          "ids": torch.arange(6, dtype=torch.int32)}
    return jt, tt


def _bits(x) -> np.ndarray:
    """The 2-byte words of a bf16 leaf of either package."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def test_bf16_file_is_byte_identical_to_jax(tmp_path):
    jt, tt = _trees()
    j_checkpoint.save(str(tmp_path / "j.ckpt"), jt)
    checkpoint.save(str(tmp_path / "t.ckpt"), tt)
    got = (tmp_path / "t.ckpt").read_bytes()
    assert got == (tmp_path / "j.ckpt").read_bytes()
    # an ml_dtypes bf16 array (what JAX hands numpy) goes the same way
    checkpoint.save(str(tmp_path / "n.ckpt"),
                    {k: (np.asarray(v) if not isinstance(v, dict) else
                         {kk: np.asarray(vv) for kk, vv in v.items()})
                     for k, v in jt.items()})
    assert (tmp_path / "n.ckpt").read_bytes() == got


def test_port_restores_jax_bf16_file(tmp_path):
    jt, tt = _trees()
    j_checkpoint.save(str(tmp_path / "j.ckpt"), jt)
    back = checkpoint.restore(str(tmp_path / "j.ckpt"))
    assert set(back) == {"blocks/w", "blocks/emb", "empty", "scale", "fp32",
                         "ids"}
    for key, want in (("blocks/w", tt["blocks"]["w"]),
                      ("blocks/emb", tt["blocks"]["emb"]),
                      ("empty", tt["empty"]), ("scale", tt["scale"])):
        got = back[key]
        assert isinstance(got, torch.Tensor), key
        assert got.dtype == torch.bfloat16 and got.device.type == "cpu"
        assert got.shape == want.shape, key
        assert np.array_equal(_bits(got), _bits(want)), key
        got.add_(1)                           # a writable copy of its own
    assert isinstance(back["fp32"], np.ndarray)
    assert back["fp32"].dtype == np.float32
    np.testing.assert_array_equal(back["ids"], np.arange(6, dtype=np.int32))


def test_jax_restores_port_bf16_file(tmp_path):
    jt, tt = _trees()
    checkpoint.save(str(tmp_path / "t.ckpt"), tt)
    back = j_checkpoint.restore(str(tmp_path / "t.ckpt"))
    for key, want in (("blocks/w", jt["blocks"]["w"]),
                      ("blocks/emb", jt["blocks"]["emb"]),
                      ("empty", jt["empty"]), ("scale", jt["scale"])):
        assert str(back[key].dtype) == "bfloat16", key
        assert np.array_equal(_bits(back[key]), _bits(want)), key
    # and the restored tree round-trips to the same bytes
    checkpoint.save(str(tmp_path / "again.ckpt"),
                    checkpoint.restore(str(tmp_path / "t.ckpt")))
    j_checkpoint.save(str(tmp_path / "jflat.ckpt"), back)
    assert ((tmp_path / "again.ckpt").read_bytes()
            == (tmp_path / "jflat.ckpt").read_bytes())


def test_bf16_manifest_roundtrip_and_truncation(tmp_path):
    _, tt = _trees()
    arrays = {"plane/0": tt["blocks"]["emb"], "n": np.arange(3)}
    mgr = CheckpointManager(str(tmp_path / "m"))
    mgr.save(1, {"kind": "bf16"}, arrays)
    _, _, back = mgr.load_latest()
    assert torch.equal(back["plane/0"], arrays["plane/0"])
    # a bf16 record one byte short fails loudly, counted at 2 bytes a word
    rec = {"dtype": "bfloat16", "shape": [3, 5], "data": b"\0" * 29}
    with pytest.raises(CheckpointError, match="29 bytes for dtype=bfloat16 "
                                              r"shape=\(3, 5\) \(want 30\)"):
        checkpoint._decode_leaf("w", rec)


def test_port_only_process_restores_jax_bf16_file(tmp_path):
    """A process that imports the port and neither JAX nor ``ml_dtypes``
    reads JAX's bf16 file (the card's machine has no ``ml_dtypes``)."""
    jt, tt = _trees()
    path = tmp_path / "j.ckpt"
    j_checkpoint.save(str(path), jt)
    np.save(tmp_path / "want.npy", _bits(tt["blocks"]["emb"]))
    code = (
        "import sys, numpy as np, torch\n"
        "from repro_torch.ckpt import checkpoint\n"
        f"back = checkpoint.restore({str(path)!r})\n"
        "got = back['blocks/emb']\n"
        "assert got.dtype == torch.bfloat16, got.dtype\n"
        f"want = np.load({str(tmp_path / 'want.npy')!r})\n"
        "assert np.array_equal(got.view(torch.int16).numpy()"
        ".view(np.uint16), want)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok', len(back))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok 6"
