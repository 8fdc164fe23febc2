"""msgpack-format pytree checkpoints, with no msgpack dependency.

Layout: <dir>/step_<n>.ckpt — a msgpack map {path: {dtype, shape, data}}
with tree paths as stable keys, so restore does not need the live pytree
and returns the flat map.  Paths are dict keys joined by "/" (list
positions by their index), in the JAX package's flatten order: sorted dict
keys, then list order.

The file is the JAX package's (``repro.ckpt.checkpoint``), written by a
small encoder of the msgpack subset it uses: maps, UTF-8 strings, bin
payloads, arrays and non-negative ints, each in msgpack's shortest form.
For the same arrays the two packages write the same bytes, and each
restores the other's file.  bf16 leaves, which numpy cannot hold without
``ml_dtypes``, travel as their raw 2-byte words under the dtype string
``"bfloat16"``, as JAX writes a ``jnp.bfloat16`` leaf; they restore as
CPU ``torch.bfloat16`` tensors.

Failure handling is strict: every malformed input — truncated file,
undecodable bytes, a type outside the subset, a byte count that does not
match the record's dtype and shape — raises ``CheckpointError``.  Restored arrays are WRITABLE
copies, never read-only views of the file's bytes.
"""
from __future__ import annotations

import math
import os
import re
import struct

import numpy as np
import torch


class CheckpointError(RuntimeError):
    """A checkpoint file is missing, truncated or corrupt.  The manifest layer catches this to fall back
    to an older valid checkpoint."""


# ------------------------------------------------------------ msgpack subset
def _head(out: bytearray, n: int, fix: int | None, fix_max: int,
          codes: tuple) -> None:
    """Type byte and length of a string, bin, array or map of length n."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt in zip(codes, (">B", ">H", ">I")):
        if code is not None and n < 1 << (8 * struct.calcsize(fmt)):
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} does not fit msgpack's 32-bit lengths")


def _pack(obj, out: bytearray) -> None:
    if isinstance(obj, dict):
        _head(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _head(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(obj, (bytes, bytearray)):
        _head(out, len(obj), None, -1, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, int) and not isinstance(obj, bool) and obj >= 0:
        if obj < 0x80:
            out.append(obj)
        else:
            for code, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"),
                              (0xCF, ">Q")):
                if obj < 1 << (8 * struct.calcsize(fmt)):
                    out.append(code)
                    out += struct.pack(fmt, obj)
                    return
            raise ValueError(f"int {obj} does not fit msgpack's uint64")
    else:
        raise TypeError(f"cannot encode {type(obj).__name__} in a checkpoint")


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.buf):
            raise CheckpointError(f"truncated: {n} bytes wanted at offset "
                                  f"{self.pos} of {len(self.buf)}")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def uint(self, size: int) -> int:
        return int.from_bytes(self.take(size), "big")

    def obj(self):
        b = self.uint(1)
        if b < 0x80:
            return b
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        sizes = {0xCC: 1, 0xCD: 2, 0xCE: 4, 0xCF: 8}
        if b in sizes:
            return self.uint(sizes[b])
        for codes, read in (((0xD9, 0xDA, 0xDB), self.str),
                            ((0xC4, 0xC5, 0xC6), self.take),
                            ((None, 0xDC, 0xDD),
                             lambda n: [self.obj() for _ in range(n)]),
                            ((None, 0xDE, 0xDF), self.map)):
            if b in codes:
                return read(self.uint(1 << codes.index(b)))
        raise CheckpointError(f"type byte {b:#04x} at offset {self.pos - 1} "
                              "is outside the checkpoint format")

    def str(self, n: int) -> str:
        try:
            return self.take(n).decode("utf-8")
        except UnicodeDecodeError as e:
            raise CheckpointError(f"string is not UTF-8: {e}") from e

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            if not isinstance(k, str):
                raise CheckpointError(f"map key {k!r} is not a string")
            out[k] = self.obj()
        return out


def unpackb(buf: bytes):
    rd = _Reader(buf)
    out = rd.obj()
    if rd.pos != len(buf):
        raise CheckpointError(f"{len(buf) - rd.pos} bytes of extra data "
                              "after the payload")
    return out


# ------------------------------------------------------------ pytrees
def _flatten(tree, prefix: str = "") -> list:
    """(path, leaf) pairs in the JAX flatten order."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    return [kv for k, v in items
            for kv in _flatten(v, f"{prefix}/{k}" if prefix else k)]


BF16 = "bfloat16"


def _host(leaf) -> tuple[str, np.ndarray]:
    """(dtype string, numpy array of the leaf's bytes).  A bf16 leaf, a
    torch tensor or a numpy array of ``ml_dtypes``' type, goes through a
    2-byte integer view of itself."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return BF16, t.view(torch.int16).numpy()
        return str(t.numpy().dtype), t.numpy()
    arr = np.asarray(leaf)
    if str(arr.dtype) == BF16:
        return BF16, arr.view(np.uint16)
    return str(arr.dtype), arr


def save(path: str, tree) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {}
    for key, leaf in _flatten(tree):
        dtype, arr = _host(leaf)
        payload[key] = {"dtype": dtype, "shape": list(arr.shape),
                        "data": arr.tobytes()}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(packb(payload))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _decode_leaf(key: str, rec):
    """One {dtype, shape, data} record -> a WRITABLE numpy array, with the
    byte count checked against the declared dtype and shape (a short read,
    the classic SIGKILL-mid-write artifact, must fail loudly).  A
    ``"bfloat16"`` record comes back as a CPU ``torch.bfloat16`` tensor,
    its 2-byte words read as ``uint16``: numpy has no bf16 type of its
    own."""
    if (not isinstance(rec, dict)
            or not {"dtype", "shape", "data"} <= set(rec)):
        raise CheckpointError(f"leaf {key!r} is not a {{dtype,shape,data}} "
                              "record")
    bf16 = rec["dtype"] == BF16
    try:
        dtype = np.dtype(np.uint16 if bf16 else rec["dtype"])
    except TypeError as e:
        raise CheckpointError(f"leaf {key!r} has bad dtype "
                              f"{rec['dtype']!r}") from e
    if (not isinstance(rec["shape"], list)
            or not all(isinstance(s, int) for s in rec["shape"])):
        raise CheckpointError(f"leaf {key!r} has bad shape {rec['shape']!r}")
    shape = tuple(rec["shape"])
    want = int(math.prod(shape)) * dtype.itemsize
    data = rec["data"]
    if not isinstance(data, bytes) or len(data) != want:
        got = len(data) if isinstance(data, bytes) else 0
        raise CheckpointError(
            f"leaf {key!r} truncated/corrupt: {got} bytes for "
            f"dtype={rec['dtype']} shape={shape} (want {want})")
    arr = np.frombuffer(data, dtype=dtype).reshape(shape).copy()
    if bf16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return arr


def restore(path: str) -> dict:
    """The checkpoint's {path: ndarray} map: each leaf a writable copy (a
    bf16 leaf a ``torch.bfloat16`` tensor)."""
    try:
        with open(path, "rb") as f:
            buf = f.read()
    except OSError as e:
        raise CheckpointError(f"cannot read checkpoint {path!r}: {e}") from e
    try:
        payload = unpackb(buf)
    except CheckpointError as e:
        raise CheckpointError(f"undecodable checkpoint {path!r}: {e}") from e
    if not isinstance(payload, dict):
        raise CheckpointError(f"checkpoint {path!r} is not a map")
    return {k: _decode_leaf(k, v) for k, v in payload.items()}


def save_step(ckpt_dir: str, step: int, tree, keep: int = 3) -> str:
    path = os.path.join(ckpt_dir, f"step_{step:08d}.ckpt")
    save(path, tree)
    ckpts = sorted(f for f in os.listdir(ckpt_dir)
                   if re.match(r"step_\d+\.ckpt$", f))
    for old in ckpts[:-keep]:
        os.remove(os.path.join(ckpt_dir, old))
    return path


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.match(r"step_(\d+)\.ckpt$", f))]
    return max(steps) if steps else None
