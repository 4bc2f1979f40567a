"""ctypes binding for the native C++ batch image loader.

``io_loader.cc`` is a verbatim copy of ``imagent_tpu/native/io_loader.cc``
(the same C ABI and ``il_version``): threaded libjpeg/libpng/libwebp
decode + triangle resize with the GIL released, one process, N threads.
This module builds it at first use with ``g++`` and the JAX build's
flags into ``build/native/`` beside the package (git-ignored; the
library's name carries a hash of the source, so an edited source
rebuilds by itself), and binds it with ctypes. It never loads the JAX
package's library.

``available()`` is False when the toolchain or the headers are missing;
``unavailable_reason()`` then says why, and the loaders name the
decode path actually used on the start-up line (no silent fallback).

Copy of ``imagent_tpu/native/loader.py`` for the PyTorch port, which
imports nothing of the JAX package. numpy only, no torch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().with_name("io_loader.cc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

# -ffp-contract=off: exp_shared/sample_crop must round exactly like the
# Python port (two roundings per p*f+c, never fused) — GCC's default
# contraction would emit fma on targets that have it and silently break
# cross-path augmentation parity. No -march=native: the library may be
# shared by heterogeneous hosts.
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-ffp-contract=off", "-shared")
# libwebp is optional: hosts without its headers still get the native
# jpeg/png path; webp members then fall to the per-file PIL rescue.
_VARIANTS = (("-ljpeg", "-lpng", "-lwebp"),
             ("-DIL_NO_WEBP", "-ljpeg", "-lpng"))

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_failure: str | None = None  # why the library could not be built/loaded

# Must match io_loader.cc::il_version(). Bump BOTH on any C-ABI change.
_ABI_VERSION = 4


def library_path() -> Path:
    """Where this source's library is built (keyed on source + flags)."""
    key = hashlib.sha256(_SRC.read_bytes()
                         + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libimagent_io_{key[:16]}.so"


def _build(out: Path) -> str | None:
    """Compile to a pid-unique temp file, then ``os.replace`` it (atomic
    on POSIX): ranks starting together never load a half-written
    library. Returns None on success, else the reason."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    why = "no build attempted"
    for libs in _VARIANTS:
        cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC), *libs]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True,
                           timeout=120)
        except FileNotFoundError:
            why = "g++ not found"
            break
        except subprocess.CalledProcessError as e:
            errors = [ln.split("error: ", 1)[1]
                      for ln in (e.stderr or "").splitlines()
                      if "error: " in ln]
            why = f"g++ failed: {errors[0] if errors else e.returncode}"
            continue
        except subprocess.TimeoutExpired:
            why = "g++ timed out"
            continue
        os.replace(tmp, out)
        return None
    try:
        os.unlink(tmp)
    except OSError:
        pass
    return why


def _abi_version(lib: ctypes.CDLL) -> int:
    try:
        fn = lib.il_version
    except AttributeError:
        return -1
    fn.restype = ctypes.c_int
    fn.argtypes = []
    return int(fn())


def _bind(lib: ctypes.CDLL) -> None:
    lib.il_decode_resize_batch.restype = ctypes.c_int64
    lib.il_decode_resize_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
    ]
    lib.il_sample_crop.restype = None
    lib.il_sample_crop.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.c_uint64, ctypes.POINTER(ctypes.c_float)]
    lib.il_has_webp.restype = ctypes.c_int
    lib.il_has_webp.argtypes = []


def _load() -> ctypes.CDLL | None:
    global _lib, _failure
    with _lock:
        if _lib is not None or _failure is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _failure = _build(path)
            if _failure is not None:
                return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            _failure = f"cannot load {path.name}: {e}"
            return None
        if _abi_version(lib) != _ABI_VERSION:
            _failure = (f"{path.name} has C ABI {_abi_version(lib)}, "
                        f"expected {_ABI_VERSION}")
            return None
        _bind(lib)
        _lib = lib
        return _lib


def available() -> bool:
    """True once the native library is built and loadable."""
    return _load() is not None


def unavailable_reason() -> str | None:
    """Why ``available()`` is False (None while it is True)."""
    _load()
    return _failure


def has_webp() -> bool:
    """Whether this build decodes webp natively (libwebp present at
    build time). Without it, webp members fall to the per-file PIL
    rescue — correct, just slower for webp-heavy datasets."""
    lib = _load()
    return lib is not None and bool(lib.il_has_webp())


DEFAULT_AUG = (0.08, 1.0, 3.0 / 4.0, 4.0 / 3.0, 0.5)
"""torchvision RandomResizedCrop defaults + hflip p: (scale_min, scale_max,
ratio_min, ratio_max, hflip_prob)."""


def aug_params7(aug_params: tuple = DEFAULT_AUG) -> np.ndarray:
    """The 7-float C-side parameter block: the 5 public params plus
    fp32 log(ratio_min/max) precomputed HERE so no libm call enters the
    sampled stream — the C sampler and the PIL path's Python port
    (data/imagefolder.py::_sample_crop) then round identically."""
    p = np.asarray(aug_params, np.float32)
    if p.shape != (5,):
        raise ValueError(f"aug_params must be 5 floats, got {aug_params!r}")
    logs = np.log(p[2:4].astype(np.float64)).astype(np.float32)
    return np.ascontiguousarray(np.concatenate([p, logs]))


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_failure}")
    return lib


def decode_resize_batch(paths: list[str], size: int, mean, std,
                        n_threads: int = 0,
                        aug_seeds: np.ndarray | None = None,
                        aug_params: tuple = DEFAULT_AUG,
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Decode+resize+normalize a batch of image files natively.

    Returns ``(images, ok)``: float32 (N, size, size, 3) and a bool mask of
    successfully decoded rows (failed rows are zero; the caller re-decodes
    those with PIL).

    ``aug_seeds`` (uint64, one per image) switches on RandomResizedCrop +
    horizontal flip with ``aug_params`` bounds; each image's crop is a pure
    function of its seed, so epochs are reproducible.
    """
    lib = _require()
    n = len(paths)
    # np.empty, not zeros: every successfully decoded row is fully
    # written by the C side; failed rows are zeroed below.
    out = np.empty((n, size, size, 3), np.float32)
    ok = np.zeros((n,), np.uint8)
    if n == 0:
        return out, ok.astype(bool)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    mean_a = np.ascontiguousarray(mean, np.float32)
    std_a = np.ascontiguousarray(std, np.float32)
    if mean_a.shape != (3,) or std_a.shape != (3,):
        raise ValueError("mean and std must be 3 floats each")
    seeds_a = params_a = None
    c_seeds = c_params = None
    if aug_seeds is not None:
        if len(aug_seeds) != n:
            raise ValueError(f"{len(aug_seeds)} seeds for {n} images")
        seeds_a = np.ascontiguousarray(aug_seeds, np.uint64)
        params_a = aug_params7(aug_params)
        c_seeds = seeds_a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
        c_params = params_a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    lib.il_decode_resize_batch(
        c_paths, n, size,
        mean_a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std_a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        c_params, c_seeds,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        int(n_threads))
    okb = ok.astype(bool)
    if not okb.all():
        out[~okb] = 0.0
    return out, okb


RAW_MEAN = (0.0, 0.0, 0.0)
RAW_STD = (1.0 / 255.0,) * 3
"""Identity normalization constants. The C kernel folds the scaling
into ONE constant before touching pixels (``scale_c = inv255 / std``,
then ``out = acc * scale_c + bias``): with std exactly f32(1/255),
``scale_c == 1.0`` bit-exactly and mean 0 makes the bias -0.0 — so the
output is the raw resampled value in [0, 255], still fractional;
``decode_batch_uint8``'s rint is the actual quantization."""


def decode_batch_uint8(paths: list[str], size: int, n_threads: int = 0,
                       aug_seeds: np.ndarray | None = None,
                       aug_params: tuple = DEFAULT_AUG,
                       ) -> tuple[np.ndarray, np.ndarray]:
    """uint8 wire-format decode: the same native kernel driven with the
    identity constants above, rounded to uint8 — the canonical host-side
    batch format (``data/pipeline.py::Batch``)."""
    out, ok = decode_resize_batch(paths, size, RAW_MEAN, RAW_STD,
                                  n_threads=n_threads, aug_seeds=aug_seeds,
                                  aug_params=aug_params)
    # Round-to-nearest like PIL's own uint8 resample output; the clip
    # guards fp dust at the range edges (taps are convex weights).
    np.rint(out, out)
    np.clip(out, 0.0, 255.0, out=out)
    return out.astype(np.uint8), ok


def sample_crop(w: int, h: int, seed: int,
                aug_params: tuple = DEFAULT_AUG) -> tuple:
    """The C sampler's (x, y, cw, ch, flip) for one (size, seed) — the
    ground truth the PIL path's Python port is held to."""
    lib = _require()
    params = aug_params7(aug_params)
    out = np.zeros((5,), np.float32)
    lib.il_sample_crop(
        int(w), int(h),
        params.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(seed) & ((1 << 64) - 1),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return (int(out[0]), int(out[1]), int(out[2]), int(out[3]),
            bool(out[4] > 0.5))
