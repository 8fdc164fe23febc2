"""Manifest-backed checkpoint directory: CRC32 validation, atomic
write-then-rename, keep-K rotation, and restore that degrades to the newest
*valid* checkpoint instead of crashing.

Layout::

    <ckpt_dir>/MANIFEST.json            # {"format": 1, "checkpoints": [...]}
    <ckpt_dir>/step_00000004/arrays.ckpt   # msgpack leaves (ckpt.checkpoint)
    <ckpt_dir>/step_00000004/meta.json     # JSON-safe run metadata

Each manifest entry records the byte size and CRC32 of every file in its
step directory, so a SIGKILL mid-write (torn arrays.ckpt), bit rot
(garbage), or a deleted leaf file are all detected *before* deserialization.
Writes land in a dot-prefixed temp directory first and become visible via a
single ``os.replace``; the manifest itself is rewritten the same way — a
reader never observes a half-written checkpoint.

``load_latest`` walks entries newest-first, logs a warning for each invalid
one, and returns the first that passes CRC + decode — the graceful-
degradation contract the fault-injection suite pins down.  A corrupt or
missing manifest falls back to scanning ``step_*`` directories (decode-only
validation).
"""
from __future__ import annotations

import json
import logging
import os
import re
import shutil
import zlib

from repro_torch.ckpt import checkpoint
from repro_torch.ckpt.checkpoint import CheckpointError

log = logging.getLogger("repro_torch.ckpt")

MANIFEST = "MANIFEST.json"
ARRAYS_FILE = "arrays.ckpt"
META_FILE = "meta.json"
MANIFEST_FORMAT = 1


def crc32_file(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while block := f.read(chunk):
            crc = zlib.crc32(block, crc)
    return crc & 0xFFFFFFFF


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return   # platform without directory fds
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_json_atomic(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class CheckpointManager:
    """Versioned run-state checkpoints under one directory (see module doc)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self.dir = ckpt_dir
        self.keep = keep
        os.makedirs(ckpt_dir, exist_ok=True)

    # ------------------------------------------------------------ write path
    def save(self, step: int, meta: dict, arrays: dict) -> str:
        """Atomically write checkpoint ``step`` (JSON-safe ``meta`` + a flat
        ``{name: ndarray}`` payload), update the manifest, rotate old steps.
        Returns the final step-directory path."""
        name = f"step_{step:08d}"
        final = os.path.join(self.dir, name)
        tmp = os.path.join(self.dir, "." + name + ".tmp")
        for stale in (tmp, final):
            if os.path.exists(stale):
                shutil.rmtree(stale)
        os.makedirs(tmp)
        checkpoint.save(os.path.join(tmp, ARRAYS_FILE), arrays)
        _write_json_atomic(os.path.join(tmp, META_FILE), meta)
        files = {fn: {"bytes": os.path.getsize(os.path.join(tmp, fn)),
                      "crc32": crc32_file(os.path.join(tmp, fn))}
                 for fn in (ARRAYS_FILE, META_FILE)}
        os.replace(tmp, final)
        _fsync_dir(self.dir)

        entries = [e for e in self._manifest_entries() if e["step"] != step]
        entries.append({"step": step, "dir": name, "files": files})
        entries.sort(key=lambda e: e["step"])
        entries = entries[-self.keep:]
        _write_json_atomic(os.path.join(self.dir, MANIFEST),
                           {"format": MANIFEST_FORMAT, "checkpoints": entries})
        keep_dirs = {e["dir"] for e in entries}
        for fn in os.listdir(self.dir):
            if (re.match(r"^\.?step_\d+(\.tmp)?$", fn)
                    and fn not in keep_dirs):
                shutil.rmtree(os.path.join(self.dir, fn), ignore_errors=True)
        return final

    # ------------------------------------------------------------ read path
    def _manifest_entries(self) -> list[dict]:
        """Entries from MANIFEST.json (oldest first); scans ``step_*`` dirs
        (entries without CRCs) when the manifest is absent or unreadable."""
        path = os.path.join(self.dir, MANIFEST)
        try:
            with open(path) as f:
                doc = json.load(f)
            entries = list(doc["checkpoints"])
            entries.sort(key=lambda e: int(e["step"]))
            return entries
        except FileNotFoundError:
            pass
        except (OSError, ValueError, KeyError, TypeError) as e:
            log.warning("checkpoint manifest %s unreadable (%s); "
                        "falling back to directory scan", path, e)
        entries = []
        for fn in sorted(os.listdir(self.dir)) if os.path.isdir(self.dir) else []:
            m = re.match(r"^step_(\d+)$", fn)
            if m:
                entries.append({"step": int(m.group(1)), "dir": fn,
                                "files": None})
        return entries

    def steps(self) -> list[int]:
        return [int(e["step"]) for e in self._manifest_entries()]

    def _load_entry(self, entry: dict):
        d = os.path.join(self.dir, entry["dir"])
        files = entry.get("files") or {}
        for fn in (ARRAYS_FILE, META_FILE):
            p = os.path.join(d, fn)
            if not os.path.isfile(p):
                raise CheckpointError(f"{p} missing")
            want = files.get(fn)
            if want is not None:
                size = os.path.getsize(p)
                if size != int(want["bytes"]):
                    raise CheckpointError(
                        f"{p} truncated: {size} bytes (manifest says "
                        f"{want['bytes']})")
                crc = crc32_file(p)
                if crc != int(want["crc32"]):
                    raise CheckpointError(
                        f"{p} corrupt: crc32 {crc:#x} != manifest "
                        f"{int(want['crc32']):#x}")
        try:
            with open(os.path.join(d, META_FILE)) as f:
                meta = json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointError(f"{d}/{META_FILE} undecodable: {e}") from e
        arrays = checkpoint.restore(os.path.join(d, ARRAYS_FILE))
        return meta, arrays

    def load_step(self, step: int):
        """(meta, arrays) for one exact step; raises ``CheckpointError``."""
        for e in self._manifest_entries():
            if int(e["step"]) == step:
                return self._load_entry(e)
        raise CheckpointError(f"no checkpoint for step {step} in {self.dir}")

    def load_latest(self):
        """(step, meta, arrays) of the newest checkpoint that passes CRC +
        decode validation, or ``None`` when no valid checkpoint exists.
        Invalid newer checkpoints are skipped with a logged warning — never
        an exception."""
        for e in reversed(self._manifest_entries()):
            try:
                meta, arrays = self._load_entry(e)
                return int(e["step"]), meta, arrays
            except CheckpointError as err:
                log.warning("skipping invalid checkpoint step %s: %s",
                            e.get("step"), err)
        return None
