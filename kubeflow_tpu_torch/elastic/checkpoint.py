"""The resize record written at the resize barrier.

Counterpart of ``kubeflow_tpu/elastic/checkpoint.py``; its files are the
reference's byte for byte, so each package reads what the other wrote.
The full training state rides the Trainer's checkpoint; this record holds
what makes the post-resize world resumable exactly once: the barrier step,
the membership epoch and member set, and any caller extras.

- The payload is framed ``crc32hex|json`` (``json.dumps`` with sorted
  keys; the crc of its UTF-8 bytes, eight lower-case hex digits).
- It is written to ``resize.json.tmp``, flushed, fsynced and renamed over
  ``resize.json``, so a crash at any point leaves the previous complete
  record or the new one.
- Every file operation goes through ``FileIO`` (a trimmed copy of the
  reference's ``core/persistence.py::FileIO``), so a test can fail each
  one.

``load`` returns None for a missing file or a frame that fails its check:
a torn record is never trusted.
"""

from __future__ import annotations

import json
import os
import zlib

FILENAME = "resize.json"


class FileIO:
    """The file operations the record needs: the seam a test replaces to
    fail a write at any boundary."""

    def open(self, path: str, mode: str = "r", encoding: str | None = None):
        return open(path, mode, encoding=encoding)

    def fsync(self, f) -> None:
        os.fsync(f.fileno())

    def replace(self, src: str, dst: str) -> None:
        os.replace(src, dst)


def frame(payload: str) -> str:
    """``payload`` behind its crc32 in eight hex digits and a ``|``."""
    return f"{zlib.crc32(payload.encode()) & 0xFFFFFFFF:08x}|{payload}"


def unframe(framed: str) -> str | None:
    """The payload of a frame whose crc matches, else None."""
    crc, sep, payload = framed.partition("|")
    if sep != "|" or len(crc) != 8:
        return None
    try:
        ok = int(crc, 16) == (zlib.crc32(payload.encode()) & 0xFFFFFFFF)
    except ValueError:
        return None
    return payload if ok else None


class ResizeCheckpoint:
    """Atomic single-record store for the latest resize barrier."""

    def __init__(self, directory: str, *, io: FileIO | None = None):
        self.dir = os.path.abspath(directory)
        self.io = io or FileIO()
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, FILENAME)

    def save(self, *, step: int, epoch: int, members,
             extra: dict | None = None) -> None:
        """Persist one barrier record (tmp, flush, fsync, replace)."""
        record = {"step": int(step), "epoch": int(epoch),
                  "members": [int(m) for m in sorted(members)]}
        if extra:
            record["extra"] = extra
        tmp = self.path + ".tmp"
        f = self.io.open(tmp, "w", encoding="utf-8")
        try:
            f.write(frame(json.dumps(record, sort_keys=True)))
            f.flush()
            self.io.fsync(f)
        finally:
            f.close()
        self.io.replace(tmp, self.path)

    def load(self) -> dict | None:
        """The latest complete record, or None (missing, or a frame that
        fails its crc)."""
        try:
            f = self.io.open(self.path, "r", encoding="utf-8")
        except OSError:
            return None
        try:
            framed = f.read()
        except OSError:
            return None
        finally:
            f.close()
        payload = unframe(framed)
        if payload is None:
            return None
        try:
            return json.loads(payload)
        except ValueError:
            return None
