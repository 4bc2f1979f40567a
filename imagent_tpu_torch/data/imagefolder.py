"""ImageFolder pipeline: parallel JPEG decode + resize, uint8 wire.

Replaces the reference's ``datasets.ImageNet`` + transform stack
(``imagenet.py:280-296``: Resize((448,448)) → ToTensor → Normalize(0.5)),
``DistributedSampler`` sharding (``imagenet.py:346-347``) and the
10-worker pinned-memory ``DataLoader`` (``imagenet.py:350-359``).
Normalization does NOT happen here: the decoders hand back the uint8
array untouched and ``(x/255 - mean)/std`` runs inside the train step
(``train.make_input_prep``).

Layout expected: ``root/{train,val}/<class_name>/*.{jpg,jpeg,png,...}``
with classes mapped to indices in sorted order (torchvision
ImageFolder contract, which ``datasets.ImageNet`` reduces to).

Two decode paths, named on the start-up line (``decode_path``):

* native (the default, ``--native-io``): ``native/io_loader.cc``, one
  call per batch, ``--workers`` threads with the GIL released; a file it
  cannot decode is re-decoded with PIL (the per-file rescue);
* PIL: a spawn-context pool of ``--workers`` processes (``0`` =
  in-process). The workers import this module, whose import chain holds
  no torch.

Both draw augmentation crops from the same splitmix64 stream
(``_sample_crop`` == ``io_loader.cc::sample_crop``). An unreadable file
is zero-filled and counted (``quarantined``), never fatal. Pillow is
imported lazily: where the PIL path is needed and Pillow is absent, the
loader refuses (``DecoderMissing``, exit 78) instead of zero-filling
every image.

``epoch()`` is a plain generator: the device ``Prefetcher``'s thread
drives it, so the decode of batch k+1 overlaps the step on batch k.

Copy of ``imagent_tpu/data/imagefolder.py`` for the PyTorch port; for
the same config both packages yield byte-identical PIL-path batches
(tests/test_torch_port_imagefolder.py). The decode offload and the
fault-injection points are not ported yet.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from imagent_tpu_torch.config import Config
from imagent_tpu_torch.data import stream
from imagent_tpu_torch.data.pipeline import Batch, pad_batch, to_wire
# Pure-Python module (no library load at import): the shared
# crop-parameter derivation, so both decode paths use identical fp32
# constants.
from imagent_tpu_torch.native.loader import aug_params7
from imagent_tpu_torch.resilience.retry import retry_call

_DEFAULT_P7 = aug_params7()

_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}

# Worker-process globals (set by _init_worker).
_W: dict = {}


class DecoderMissing(ValueError):
    """Pillow is needed (as the decoder, or to rescue a file the native
    decoder cannot read) and cannot be imported. A ``ValueError``, so
    the entry point exits 78 (fatal-config): zero-filling every image
    would train on nothing without a word."""


def pil_missing() -> str | None:
    """Why Pillow cannot be imported, or None when it can."""
    try:
        from PIL import Image  # noqa: F401
    except ImportError as e:
        return str(e) or type(e).__name__
    return None


def scan_imagefolder(split_dir: str,
                     ) -> tuple[list[str], np.ndarray, list[str]]:
    """(paths, labels, class_names) with sorted-class indexing."""
    classes = sorted(
        d for d in os.listdir(split_dir)
        if os.path.isdir(os.path.join(split_dir, d)))
    paths: list[str] = []
    labels: list[int] = []
    for ci, cname in enumerate(classes):
        cdir = os.path.join(split_dir, cname)
        for fn in sorted(os.listdir(cdir)):
            if os.path.splitext(fn)[1].lower() in _EXTS:
                paths.append(os.path.join(cdir, fn))
                labels.append(ci)
    return paths, np.asarray(labels, np.int64), classes


def _init_worker(size: int):
    _W["size"] = size


_U64 = (1 << 64) - 1


def _splitmix64(state: list) -> int:
    """Bit-exact port of ``io_loader.cc::splitmix64`` — the PIL path
    consumes the SAME stream as the native decoder, so a (seed, epoch,
    row) triple yields the same crop/flip on both paths."""
    state[0] = (state[0] + 0x9E3779B97F4A7C15) & _U64
    z = state[0]
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _U64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _U64
    return z ^ (z >> 31)


def _uniform01(state: list) -> np.float32:
    # C: float(u64 >> 11) * 0x1.0p-53f — keep the fp32 rounding.
    return np.float32(np.float32(_splitmix64(state) >> 11)
                      * np.float32(2.0 ** -53))


def _lround(x: np.float32) -> int:
    # io_loader.cc::lround_shared — floor(x + 0.5f) on both sides.
    return int(np.floor(np.float32(x + np.float32(0.5))))


_EXP_COEFFS = tuple(np.float32(c) for c in (
    1.5403530393381608e-4, 1.3333558146428443e-3, 9.618129107628477e-3,
    5.550410866482158e-2, 2.402265069591007e-1, 6.9314718056e-1, 1.0))
_LOG2E = np.float32(1.4426950408889634)


def _exp_shared(x: np.float32) -> np.float32:
    """Operation-for-operation mirror of ``io_loader.cc::exp_shared``:
    degree-6 Taylor of 2^f + bit-assembled exponent, basic fp32 ops
    only — numpy's np.exp and libm's expf differ by 1 ULP on ~38% of
    inputs, which crosses lround boundaries ~1.8e-5/sample, so neither
    may participate in the shared augmentation stream."""
    t = np.float32(x * _LOG2E)
    fn = np.float32(np.floor(t))
    f = np.float32(t - fn)
    p = _EXP_COEFFS[0]
    for c in _EXP_COEFFS[1:]:
        p = np.float32(np.float32(p * f) + c)
    n = int(fn)
    scale = np.array((n + 127) << 23, np.uint32).view(np.float32)[()]
    return np.float32(p * scale)


def _sample_crop(w: int, h: int, seed: int, aug_params=None):
    """torchvision ``RandomResizedCrop.get_params`` (default scale
    (0.08, 1), ratio (3/4, 4/3)) + hflip(0.5): bit-exact port of
    ``io_loader.cc::sample_crop`` including its fp32 arithmetic, so both
    decode paths draw identical augmentations from one seed.
    ``aug_params`` is the same 5-tuple the native API takes."""

    p7 = aug_params7(aug_params) if aug_params is not None else _DEFAULT_P7
    scale_min, scale_max, ratio_min, ratio_max, hflip, log_rmin, log_rmax = p7
    f32 = np.float32
    s = [seed & _U64]
    area = f32(f32(w) * f32(h))
    for _ in range(10):
        target_area = f32(area * f32(scale_min + f32(_uniform01(s)
                                     * f32(scale_max - scale_min))))
        ar = _exp_shared(f32(log_rmin + f32(_uniform01(s)
                                            * f32(log_rmax - log_rmin))))
        cw = _lround(np.sqrt(f32(target_area * ar), dtype=np.float32))
        ch = _lround(np.sqrt(f32(target_area / ar), dtype=np.float32))
        if 0 < cw <= w and 0 < ch <= h:
            x = _splitmix64(s) % (w - cw + 1)
            y = _splitmix64(s) % (h - ch + 1)
            return int(x), int(y), cw, ch, bool(_uniform01(s) < hflip)
    in_ratio = f32(f32(w) / f32(h))
    if in_ratio < ratio_min:
        cw, ch = w, _lround(f32(f32(w) / ratio_min))
    elif in_ratio > ratio_max:
        cw, ch = _lround(f32(f32(h) * ratio_max)), h
    else:
        cw, ch = w, h
    return (w - cw) // 2, (h - ch) // 2, cw, ch, bool(_uniform01(s) < hflip)


def _decode_one(path: str, aug_seed: int | None = None,
                aug_params=None) -> np.ndarray:
    """PIL decode path. ``aug_params`` must match whatever the native
    call used so a rescue re-decode draws the identical crop."""
    try:
        from PIL import Image
    except ImportError as e:
        raise DecoderMissing(f"Pillow cannot be imported ({e}); it is "
                             f"needed to decode {path}") from None
    size = _W["size"]
    with Image.open(path) as im:
        im = im.convert("RGB")
        if aug_seed is not None:
            x, y, cw, ch, flip = _sample_crop(*im.size, aug_seed,
                                              aug_params)
            im = im.resize((size, size), Image.BILINEAR,
                           box=(x, y, x + cw, y + ch))
            if flip:
                im = im.transpose(Image.FLIP_LEFT_RIGHT)
        else:
            im = im.resize((size, size), Image.BILINEAR)
        return np.asarray(im, np.uint8)


def _decode_one_robust(path: str, aug_seed: int | None = None,
                       aug_params=None) -> tuple[np.ndarray, bool]:
    """``(image, ok)``: PIL decode with jittered-backoff retries on
    OSError (transient NFS hiccups; PIL's own decode errors are OSError
    subclasses too, costing two cheap extra tries on a genuinely-bad
    file), then a zero-filled quarantine fallback — one unreadable file
    must cost a logged counter, never a multi-hour run. A missing
    Pillow is not an unreadable file: it raises."""
    try:
        return retry_call(_decode_one, path, aug_seed, aug_params,
                          attempts=3, base_delay=0.05,
                          describe=f"decode {path}"), True
    except DecoderMissing:
        raise
    except Exception:
        size = _W["size"]
        return np.zeros((size, size, 3), np.uint8), False


class ImageFolderLoader:
    def __init__(self, cfg: Config, process_index: int, process_count: int,
                 global_batch: int, split: str):
        self._init_common(cfg, process_index, process_count, global_batch,
                          split)
        split_dir = os.path.join(cfg.data_root, split)
        self.paths, self.labels, self.classes = scan_imagefolder(split_dir)
        self.num_examples = len(self.paths)
        self._set_steps()

    def _init_common(self, cfg: Config, process_index: int,
                     process_count: int, global_batch: int,
                     split: str) -> None:
        """State shared with the tar loader; resolves the decode path
        (and refuses a missing Pillow) before any data is read."""
        self.cfg = cfg
        self.split = split
        self.train = split == "train"
        self.process_index = process_index
        self.process_count = process_count
        self.global_batch = global_batch
        self.local_rows = global_batch // process_count
        self._pool = None
        self._warned_bad: set[str] = set()
        self._quarantined = 0  # unreadable files zero-filled this epoch
        self._use_native, self.decode_path = self._resolve_decode()

    def _set_steps(self) -> None:
        if self.train:
            self.steps_per_epoch = self.num_examples // self.global_batch
        else:
            self.steps_per_epoch = -(-self.num_examples // self.global_batch)

    def _resolve_decode(self) -> tuple[bool, str]:
        """``(use_native, description)``: native when ``--native-io`` is
        on and the library builds, else PIL, which then needs Pillow."""
        why = None
        if self.cfg.native_io:
            from imagent_tpu_torch.native import loader as native
            if native.available():
                return True, ("native (webp "
                              f"{'yes' if native.has_webp() else 'no'})")
            why = native.unavailable_reason()
        missing = pil_missing()
        if missing is not None:
            raise DecoderMissing(
                "the PIL decode path is needed ("
                + (f"native decoder unavailable: {why}" if why
                   else "--no-native-io")
                + f") and Pillow cannot be imported: {missing}")
        return False, f"pil (native: {why})" if why else "pil"

    @property
    def quarantined(self) -> int:
        """Unreadable samples zero-filled during the most recent epoch
        (reset at each ``epoch()`` start)."""
        return self._quarantined

    def _ensure_pool(self):
        if self._use_native:
            # The per-file PIL rescue runs in-process.
            _init_worker(self.cfg.image_size)
            return
        if self._pool is None and self.cfg.workers > 0:
            import multiprocessing as mp
            # spawn, not fork: the process is multithreaded by loader
            # time (torch, the prefetch thread). Workers import numpy,
            # PIL and this module's torch-free chain.
            ctx = mp.get_context("spawn")
            self._pool = ctx.Pool(
                self.cfg.workers, initializer=_init_worker,
                initargs=(self.cfg.image_size,))
        elif self._pool is None:
            _init_worker(self.cfg.image_size)

    def _decode_native(self, paths: list[str], seeds: np.ndarray | None,
                       warn_keys: list[str] | None = None) -> np.ndarray:
        """``warn_keys``: operator-meaningful names for quarantine
        warnings/dedup when ``paths`` are throwaway staging files."""
        keys = warn_keys if warn_keys is not None else paths
        from imagent_tpu_torch.native import loader as native
        images, ok = native.decode_batch_uint8(
            paths, self.cfg.image_size,
            n_threads=max(1, self.cfg.workers),  # workers=0 ⇒ serial,
            # matching the PIL path (native 0 would mean all cores)
            aug_seeds=seeds)
        for i in np.flatnonzero(~ok):  # per-file PIL rescue (slow path)
            img, decoded = _decode_one_robust(
                paths[i], int(seeds[i]) if seeds is not None else None)
            if decoded:
                images[i] = img
                if "rescue" not in self._warned_bad:
                    self._warned_bad.add("rescue")
                    print(f"NOTE: {keys[i]} not native-decodable "
                          "(jpeg/png/webp); PIL slow path", flush=True)
            else:
                images[i] = 0
                self._quarantine(keys[i])
        return images

    def _quarantine(self, key: str) -> None:
        self._quarantined += 1
        if key not in self._warned_bad:
            self._warned_bad.add(key)
            print(f"WARNING: undecodable image {key}; "
                  "substituting zeros", flush=True)

    def _decode_pil_batch(self, paths: list[str],
                          seeds: np.ndarray | None,
                          warn_keys: list[str] | None = None) -> np.ndarray:
        """PIL decode of a batch (pool or in-process) with per-file
        retry + zero-fill quarantine, shared by both loaders."""
        keys = warn_keys if warn_keys is not None else paths
        args = [(p, int(seeds[i]) if seeds is not None else None)
                for i, p in enumerate(paths)]
        if self._pool is not None:
            # Workers return (image, ok); their quarantines are counted
            # here in the parent.
            results = self._pool.starmap(_decode_one_robust, args,
                                         chunksize=8)
        else:
            results = [_decode_one_robust(*a) for a in args]
        for key, (_, decoded) in zip(keys, results):
            if not decoded:
                self._quarantine(key)
        imgs = [img for img, _ in results]
        return (np.stack(imgs) if imgs else np.zeros(
            (0, self.cfg.image_size, self.cfg.image_size, 3), np.uint8))

    def _aug_seeds(self, rows: np.ndarray, epoch: int) -> np.ndarray | None:
        """Per-sample uint64 seed, a pure function of (seed, epoch,
        dataset row): augmentation is reproducible and never repeats
        across epochs. Both decode paths consume it through the SAME
        splitmix64 stream."""
        if not (self.train and self.cfg.augment):
            return None
        return (rows.astype(np.uint64)
                + np.uint64(epoch) * np.uint64(0x1_0000_0000)
                + np.uint64(self.cfg.seed) * np.uint64(0x1000_0000_0000))

    def _local_decode(self, valid: np.ndarray,
                      epoch: int) -> np.ndarray:
        """Loader-specific decode body (tarshards overrides: staged
        ranged reads instead of loose files)."""
        paths = [self.paths[i] for i in valid]
        seeds = self._aug_seeds(valid, epoch)
        if self._use_native:
            return self._decode_native(paths, seeds)
        return self._decode_pil_batch(paths, seeds)

    def _decode_batch(self, rows: np.ndarray, epoch: int,
                      step: int = 0) -> Batch:
        valid = rows[rows != stream.PAD_ROW]
        stream.trace_rows(self.process_index, self.split, epoch, step,
                          valid, world=self.process_count)
        self._ensure_pool()
        images = self._local_decode(valid, epoch)
        labels = self.labels[valid].astype(np.int32)
        return pad_batch(to_wire(images, self.cfg.transfer_dtype),
                         labels, self.local_rows)

    def _stream_key(self) -> stream.StreamKey:
        """The seed-and-position key this loader's sample order is a
        pure function of (``data/stream.py`` contract)."""
        return stream.StreamKey(
            num_examples=self.num_examples,
            global_batch=self.global_batch, seed=self.cfg.seed,
            process_index=self.process_index,
            process_count=self.process_count, shuffle=self.train,
            drop_remainder=self.train)

    def epoch(self, epoch: int, start_step: int = 0) -> Iterator[Batch]:
        """Yields host-local batches, decoding each on demand in the
        caller's thread (the device ``Prefetcher``'s, on the main path).

        ``start_step`` opens the deterministic sample stream at
        ``(epoch, start_step)``: the skipped prefix is never decoded."""
        self._quarantined = 0
        for step, rows in stream.open_stream(self._stream_key(), epoch,
                                             start_step):
            yield self._decode_batch(rows, epoch, step)
        if self._quarantined:
            # Surfaced per epoch, not hidden: N zero-filled samples per
            # epoch is a data-quality signal the operator must see.
            print(f"WARNING: {self.split} epoch {epoch + 1}: "
                  f"{self._quarantined} unreadable file(s) quarantined "
                  "(zero-filled)", flush=True)

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool = None
