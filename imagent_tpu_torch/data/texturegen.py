"""Deterministic on-disk JPEG ImageFolder generator.

Produces a texture dataset (N hue-family classes with random luminance
gratings) laid out as ``root/{train,val}/class_k/*.jpg`` — the same
directory contract as torchvision's ImageFolder — and packs such a tree
into tar shards (``pack_tar_shards``). No dataset can be downloaded
where the tests and the smoke run, so they write their JPEGs with this.
Generation is a pure function of (class, index): the same parameters
always yield byte-identical datasets.

Copy of ``texture`` and ``generate_imagefolder`` of
``imagent_tpu/data/texturegen.py`` (the "hue" scheme) for the PyTorch
port, with ``height`` for non-square images (ImageNet's most common
geometry is 500x375). numpy and PIL, no torch.
"""

from __future__ import annotations

import colorsys
import json
import os
import tarfile

import numpy as np


def texture(cls: int, idx: int, n_classes: int, img: int,
            hue_jitter: float = 0.03,
            height: int | None = None) -> np.ndarray:
    """Deterministic RGB texture for (class, index), ``height`` x
    ``img`` pixels (square when ``height`` is None). ``hue_jitter``
    controls task difficulty: within-class hue spread vs the 1/n_classes
    class separation."""
    h = img if height is None else height
    rng = np.random.default_rng(cls * 100_003 + idx)
    yy, xx = np.mgrid[0:h, 0:img].astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi)
    wavelength = rng.uniform(10, 18) * img / 64.0
    theta = rng.uniform(0, np.pi)
    base = np.asarray(colorsys.hsv_to_rgb(
        (cls / n_classes + rng.uniform(-hue_jitter, hue_jitter)) % 1.0,
        0.85, 0.8), np.float32)
    wave = np.sin(2 * np.pi * (xx * np.cos(theta) + yy * np.sin(theta))
                  / wavelength + phase)
    lum = 0.75 + 0.25 * wave
    out = base[None, None, :] * lum[:, :, None]
    out = out + rng.normal(0, 0.02, out.shape)
    return (out.clip(0, 1) * 255).astype(np.uint8)


def _write_class(d: str, cls: int, per_class: int, base: int,
                 n_classes: int, img: int, quality: int, hue_jitter: float,
                 height: int | None) -> None:
    from PIL import Image

    os.makedirs(d, exist_ok=True)
    for i in range(per_class):
        Image.fromarray(texture(cls, base + i, n_classes, img, hue_jitter,
                                height)).save(
            os.path.join(d, f"{i:05d}.jpg"), quality=quality)


def generate_imagefolder(root: str, n_classes: int = 8,
                         train_per_class: int = 40, val_per_class: int = 8,
                         img: int = 64, quality: int = 90,
                         hue_jitter: float = 0.03,
                         height: int | None = None,
                         workers: int = 0) -> str:
    """Write the dataset under ``root`` (idempotent: a manifest records
    the parameters; matching manifest ⇒ reuse, mismatch ⇒ regenerate).
    Images are ``img`` wide and ``height`` (default ``img``) tall; for
    square images the files are byte-identical to the JAX package's
    ``generate_imagefolder`` with the same parameters. ``workers`` > 0
    writes the class directories from a spawn-context pool of that many
    processes (the same bytes)."""
    manifest = dict(n_classes=n_classes, train_per_class=train_per_class,
                    val_per_class=val_per_class, img=img, quality=quality,
                    hue_jitter=hue_jitter, version=1)
    if height is not None and height != img:
        manifest["height"] = height
    mpath = os.path.join(root, "manifest.json")
    if os.path.exists(mpath):
        try:
            with open(mpath) as f:
                if json.load(f) == manifest:
                    return root
        except (json.JSONDecodeError, OSError):
            pass
    # Parameter mismatch: clear stale splits so a shrunk class/image
    # count can't leave extra files for the ImageFolder scan to find.
    import shutil
    for split in ("train", "val"):
        shutil.rmtree(os.path.join(root, split), ignore_errors=True)
    if os.path.exists(mpath):
        os.remove(mpath)
    jobs = [(os.path.join(root, split, f"class_{cls}"), cls, per_class,
             base, n_classes, img, quality, hue_jitter, height)
            for split, per_class, base in (("train", train_per_class, 0),
                                           ("val", val_per_class, 10_000_000))
            for cls in range(n_classes)]
    if workers > 0:
        import multiprocessing as mp
        with mp.get_context("spawn").Pool(workers) as pool:
            pool.starmap(_write_class, jobs)
    else:
        for job in jobs:
            _write_class(*job)
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    return root


def pack_tar_shards(root: str, out_root: str, n_shards: int) -> str:
    """Pack the image-folder tree ``root/{train,val}/<class>/<file>``
    into ``out_root/{split}/shard-KKKK.tar``: every file of a split, in
    sorted order, dealt round-robin over ``n_shards`` shards as member
    ``<class>/<file>`` (the layout ``data/tarshards.py`` reads)."""
    for split in ("train", "val"):
        split_dir = os.path.join(root, split)
        files = sorted(
            (cls, fn) for cls in os.listdir(split_dir)
            if os.path.isdir(os.path.join(split_dir, cls))
            for fn in os.listdir(os.path.join(split_dir, cls)))
        out = os.path.join(out_root, split)
        os.makedirs(out, exist_ok=True)
        for k in range(n_shards):
            with tarfile.open(os.path.join(out, f"shard-{k:04d}.tar"),
                              "w") as tf:
                for cls, fn in files[k::n_shards]:
                    tf.add(os.path.join(split_dir, cls, fn),
                           arcname=f"{cls}/{fn}")
    return out_root
