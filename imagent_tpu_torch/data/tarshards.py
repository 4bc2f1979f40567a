"""Tar-shard dataset: ImageNet as ``{split}/*.tar`` archives.

Pod input commonly ships as tar shards (webdataset layout) rather than
1.28M loose files — listing a huge ImageFolder tree on networked
storage can take longer than an epoch. This loader keeps the
image-folder loader's sharding, shuffle and decode semantics while
reading members straight out of the archives:

* each shard is indexed ONCE (member name, byte offset, size) by
  walking tar headers; the index is cached next to the shard
  (``<shard>.index.json``, keyed by the shard's size and mtime) so
  later runs skip even that;
* class labels come from the member's leading directory
  (``n01440764/img.jpg``), merged across shards into one sorted class
  vocabulary — the ImageFolder contract applied inside archives;
* a batch's members are read with ``pread`` ranged reads (grouped by
  shard, ascending offset: sequential I/O) under ``retry_call`` and
  staged into tmpfs (``/dev/shm``) files for the decoders, which are
  path-based; ``close()`` removes the staging directory.

Select with ``--dataset tar``; ``--data-root`` holds ``train/*.tar``
and ``val/*.tar``.

Copy of ``imagent_tpu/data/tarshards.py`` for the PyTorch port. numpy
only, no torch.
"""

from __future__ import annotations

import json
import os
import shutil
import tarfile
import tempfile
import uuid

import numpy as np

from imagent_tpu_torch.config import Config
from imagent_tpu_torch.data.imagefolder import ImageFolderLoader
from imagent_tpu_torch.resilience.retry import retry_call

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".webp", ".bmp")


def index_shard(shard_path: str) -> list[tuple[str, int, int]]:
    """(member_name, data_offset, size) for every image member, cached
    in a JSON sidecar keyed by the shard's (size, mtime)."""
    sidecar = shard_path + ".index.json"
    st = os.stat(shard_path)
    key = [int(st.st_size), int(st.st_mtime)]
    try:
        with open(sidecar) as f:
            cached = json.load(f)
        if cached.get("key") == key:
            return [tuple(e) for e in cached["members"]]
    except (OSError, ValueError, KeyError):
        pass
    members: list[tuple[str, int, int]] = []
    with tarfile.open(shard_path, "r:") as tf:
        for m in tf:
            if m.isfile() and m.name.lower().endswith(_IMG_EXTS):
                members.append((m.name, m.offset_data, m.size))
    try:
        tmp = f"{sidecar}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump({"key": key, "members": members}, f)
        os.replace(tmp, sidecar)
    except OSError:
        pass  # read-only dataset dir: index in memory only
    return members


def scan_tar_split(split_dir: str):
    """All shards of one split → (shard_paths, per-image arrays)."""
    shards = sorted(
        os.path.join(split_dir, f) for f in os.listdir(split_dir)
        if f.endswith(".tar"))
    if not shards:
        raise FileNotFoundError(f"no .tar shards under {split_dir}")
    names: list[str] = []
    shard_of: list[int] = []
    offsets: list[int] = []
    sizes: list[int] = []
    for si, sp in enumerate(shards):
        for name, off, size in index_shard(sp):
            names.append(name)
            shard_of.append(si)
            offsets.append(off)
            sizes.append(size)
    classes = sorted({n.split("/")[0] for n in names if "/" in n})
    cls_idx = {c: i for i, c in enumerate(classes)}
    labels = np.array([cls_idx.get(n.split("/")[0], -1) for n in names],
                      np.int64)
    keep = labels >= 0
    order = np.argsort(np.asarray(names, object)[keep], kind="stable")
    # Explicit dtypes: offsets/sizes are byte positions into multi-GB
    # shards (int64 by necessity, not by platform default).
    return (shards,
            np.asarray(names, object)[keep][order],
            np.asarray(shard_of, np.int32)[keep][order],
            np.asarray(offsets, np.int64)[keep][order],
            np.asarray(sizes, np.int64)[keep][order],
            labels[keep][order],
            classes)


class TarShardLoader(ImageFolderLoader):
    """ImageFolderLoader over tar shards: identical batch semantics,
    members staged from ranged shard reads instead of loose files."""

    def __init__(self, cfg: Config, process_index: int, process_count: int,
                 global_batch: int, split: str):
        self._init_common(cfg, process_index, process_count, global_batch,
                          split)
        split_dir = os.path.join(cfg.data_root, split)
        (self._shards, self._names, self._shard_of, self._offsets,
         self._sizes, self.labels, self.classes) = scan_tar_split(split_dir)
        self.num_examples = len(self._names)
        self._set_steps()
        shm = "/dev/shm"
        self._staging = tempfile.mkdtemp(
            prefix="imagent_tar_",
            dir=shm if os.path.isdir(shm) else None)
        self._fds: dict[int, int] = {}  # shard index -> O_RDONLY fd

    def _read_member(self, r: int) -> bytes:
        """One ranged member read, reopening the shard's fd on failure —
        the retry wrapper in ``_stage_rows`` drives it through transient
        NFS errors (a stale handle must cost a reopen, not the run)."""
        si = int(self._shard_of[r])
        fd = self._fds.get(si)
        if fd is None:
            fd = os.open(self._shards[si], os.O_RDONLY)
            self._fds[si] = fd
        try:
            return os.pread(fd, int(self._sizes[r]), int(self._offsets[r]))
        except OSError:
            # Drop the cached fd so the retry reopens it.
            self._fds.pop(si, None)
            try:
                os.close(fd)
            except OSError:
                pass
            raise

    def _stage_rows(self, rows: np.ndarray) -> list[str]:
        # Ascending (shard, offset) = sequential reads within each shard.
        order = np.lexsort((self._offsets[rows], self._shard_of[rows]))
        staged: dict[int, str] = {}
        try:
            for r in rows[order]:
                data = retry_call(self._read_member, int(r), attempts=3,
                                  base_delay=0.05,
                                  describe=f"tar member read "
                                           f"{self._names[int(r)]}")
                ext = os.path.splitext(str(self._names[r]))[1] or ".img"
                path = os.path.join(self._staging,
                                    f"{uuid.uuid4().hex}{ext}")
                staged[int(r)] = path
                with open(path, "wb") as f:
                    f.write(data)
        except BaseException:
            _unlink_all(staged.values())
            raise
        return [staged[int(r)] for r in rows]

    def _local_decode(self, valid, epoch):
        """Stage the batch's tar-shard ranges, then decode them."""
        staged = self._stage_rows(valid)
        seeds = self._aug_seeds(valid, epoch)
        # Quarantine warnings/dedup key on the real member name, not the
        # throwaway /dev/shm staging name.
        member_names = [str(self._names[int(r)]) for r in valid]
        try:
            if self._use_native:
                return self._decode_native(staged, seeds,
                                           warn_keys=member_names)
            return self._decode_pil_batch(staged, seeds,
                                          warn_keys=member_names)
        finally:
            _unlink_all(staged)

    def close(self):
        super().close()
        for fd in self._fds.values():
            try:
                os.close(fd)
            except OSError:
                pass
        self._fds.clear()
        shutil.rmtree(self._staging, ignore_errors=True)


def _unlink_all(paths) -> None:
    for p in paths:
        try:
            os.unlink(p)
        except OSError:
            pass
