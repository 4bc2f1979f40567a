"""The port's image-folder and tar-shard input path against the JAX
package's, on the CPU: ``data/imagefolder.py``, ``data/tarshards.py``,
``native/loader.py`` + ``native/io_loader.cc``, ``data/pipeline.py``'s
wire dtypes and the CLI wiring.

One tiny dataset per module: 3 classes of JPEGs at odd sizes, one
300x200 JPEG at q95 (a 24 px target takes libjpeg's DCT-scaled path),
one grayscale JPEG, one RGBA PNG, one 8-bit palette BMP (not
native-decodable: the per-file PIL rescue), one corrupt JPEG and one
file the scanner skips; the same files in 2 tar shards, one copy of the
shards per package (each writes its own index sidecars). The JAX
loaders are numpy and PIL: they reach no JAX code.

* PIL path (``native_io`` off, ``workers`` 0): batches (images, labels,
  mask) byte-equal to the JAX package's for train with ``augment`` off
  and on over 2 epochs, val (padded tail), both ranks of 2, and opened
  at ``start_step=1``; for both loaders; the tar batches equal the
  image-folder ones.
* The crop sampler (Python and native) and the native decode byte-equal
  to the JAX build's; native against PIL within ±1 per pixel where no
  DCT scaling happens, mean-close where it does (the JAX package's own
  bounds, ``tests/test_native_io.py``).
* Quarantine, the wire dtypes, the torch-free import chain, a missing
  Pillow (exit 78, nothing quarantined), and the CLI on both loaders.
"""

import ast
import dataclasses
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from imagent_tpu.config import Config as JaxConfig
from imagent_tpu.data.imagefolder import ImageFolderLoader as JaxImageFolder
from imagent_tpu.data.imagefolder import _sample_crop as jax_sample_crop
from imagent_tpu.data.tarshards import TarShardLoader as JaxTar
from imagent_tpu.native import loader as jax_native
from imagent_tpu_torch.__main__ import main
from imagent_tpu_torch.config import Config
from imagent_tpu_torch.data import imagefolder
from imagent_tpu_torch.data.imagefolder import ImageFolderLoader
from imagent_tpu_torch.data.pipeline import WIRE_DTYPES, to_wire
from imagent_tpu_torch.data.prefetch import _ready, _stage_batch
from imagent_tpu_torch.data.tarshards import TarShardLoader
from imagent_tpu_torch.data.texturegen import pack_tar_shards, texture
from imagent_tpu_torch.native import loader as native
from imagent_tpu_torch.train import make_input_prep

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SIZE, BATCH = 24, 4
# (w, h); at a 24 px target libjpeg decodes a JPEG DCT-scaled when both
# sides reach 24 * 8/7 (io_loader.cc::decode_jpeg): the first two are,
# the last two are not.
ODD = ((37, 53), (64, 48), (26, 45), (45, 27))
MEAN = STD = (0.5, 0.5, 0.5)
# The JAX package's native-vs-PIL bounds (tests/test_native_io.py): ±1
# uint8 level per pixel without DCT scaling; a mean of 0.02 on the
# (x/255 - 0.5)/0.5 scale, i.e. 2.55 levels, with it.
DCT_MEAN_LEVELS = 0.02 * 127.5


def _smooth(h, w):
    """The smooth test pattern of ``tests/test_native_io.py``."""
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([
        128 + 100 * np.sin(xx / 60) * np.cos(yy / 45),
        128 + 80 * np.cos(xx / 80 + 1),
        64 + (xx + yy) * 0.2,
    ], -1).clip(0, 255).astype(np.uint8)


def _save(path, arr, **kw):
    Image.fromarray(arr).save(path, **kw)


def _write_split(split_dir: Path, specials: bool, per_class: int) -> None:
    for c in range(3):
        d = split_dir / f"class_{c}"
        d.mkdir(parents=True)
        for i in range(per_class):
            w, h = ODD[(c + i) % len(ODD)]
            _save(d / f"{i:02d}.jpg", texture(c, i, 3, w, height=h),
                  quality=90)
    d = split_dir / "class_0"
    _save(d / "big.jpg", _smooth(200, 300), quality=95)
    _save(d / "gray.jpg", texture(0, 98, 3, 40, height=30)[..., 0])
    rgba = np.dstack([texture(0, 97, 3, 33, height=45),
                      np.full((45, 33), 200, np.uint8)])
    _save(d / "rgba.png", rgba)
    Image.fromarray(texture(0, 96, 3, 28, height=36)).convert("P").save(
        d / "palette.bmp")
    (d / "corrupt.jpg").write_bytes(b"\xff\xd8\xffgarbage-not-a-jpeg")
    if specials:
        (d / "notes.txt").write_text("not an image")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """``{"folder": root, "tar_jax": root, "tar_port": root}``: 20 train
    and 11 val images (5 of each split's are the special files in
    class_0) and one skipped file."""
    root = tmp_path_factory.mktemp("imgs")
    folder = root / "folder"
    _write_split(folder / "train", True, 5)
    _write_split(folder / "val", False, 2)
    pack_tar_shards(str(folder), str(root / "tar_jax"), 2)
    shutil.copytree(root / "tar_jax", root / "tar_port")
    return {"folder": str(folder), "tar_jax": str(root / "tar_jax"),
            "tar_port": str(root / "tar_port")}


@pytest.fixture(autouse=True)
def _no_backoff_waits(monkeypatch):
    """Every retry still runs (the corrupt file is tried three times on
    both sides), without the jittered backoff's sleeps between tries."""
    import imagent_tpu.resilience.retry as jax_retry

    from imagent_tpu_torch.resilience import retry
    for mod in (jax_retry, retry):
        monkeypatch.setattr(
            mod, "backoff_delays",
            lambda attempts, *a, **k: iter([0.0] * (attempts - 1)))


def _pair(root, **kw):
    kw = {"data_root": root, "image_size": SIZE, "workers": 0,
          "native_io": False, **kw}
    return JaxConfig(**kw), Config(**kw)


def _batches(loader, epochs=(0,), start_step=0):
    try:
        return [b for e in epochs for b in loader.epoch(e, start_step)]
    finally:
        loader.close()


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.images.dtype == w.images.dtype == np.uint8
        np.testing.assert_array_equal(g.images, w.images)
        np.testing.assert_array_equal(g.labels, w.labels)
        np.testing.assert_array_equal(g.mask, w.mask)


CASES = {  # id: (split, augment, rank, world, start_step)
    "train": ("train", False, 0, 1, 0),
    "train_augment": ("train", True, 0, 1, 0),
    "val": ("val", False, 0, 1, 0),
    "rank0of2": ("train", True, 0, 2, 0),
    "rank1of2": ("train", True, 1, 2, 0),
    "val_rank1of2": ("val", False, 1, 2, 0),
    "start_step1": ("train", True, 0, 1, 1),
}


@pytest.mark.parametrize("dataset", ["imagefolder", "tar"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_pil_batches_byte_equal_to_jax(data, dataset, case):
    split, augment, rank, world, start = CASES[case]
    epochs = (0, 1) if split == "train" else (0,)
    if dataset == "tar":
        jcfg, _ = _pair(data["tar_jax"], augment=augment)
        _, tcfg = _pair(data["tar_port"], augment=augment)
        jax_cls, port_cls = JaxTar, TarShardLoader
    else:
        jcfg, tcfg = _pair(data["folder"], augment=augment)
        jax_cls, port_cls = JaxImageFolder, ImageFolderLoader
    want_loader = jax_cls(jcfg, rank, world, BATCH, split)
    got_loader = port_cls(tcfg, rank, world, BATCH, split)
    assert got_loader.decode_path == "pil"
    assert got_loader.steps_per_epoch == want_loader.steps_per_epoch
    want = _batches(want_loader, epochs, start)
    got = _batches(got_loader, epochs, start)
    _assert_batches_equal(got, want)
    assert got_loader.quarantined == want_loader.quarantined
    if split == "val" and world == 1:
        # 11 images in batches of 4: the tail is padded, and the corrupt
        # file is zero-filled.
        assert got[-1].mask.tolist() == [1, 1, 1, 0]
        assert got_loader.quarantined == 1
        rows = np.concatenate([b.images for b in got])
        names = [os.path.basename(p) for p in (
            got_loader.paths if dataset == "imagefolder"
            else got_loader._names)]
        assert not rows[names.index("corrupt.jpg")].any()
    if split == "val" and world == 2:
        assert got[-1].mask.tolist() == [1, 0]


def test_tar_batches_equal_image_folder_batches(data):
    for augment in (False, True):
        _, folder_cfg = _pair(data["folder"], augment=augment)
        _, tar_cfg = _pair(data["tar_port"], augment=augment)
        _assert_batches_equal(
            _batches(TarShardLoader(tar_cfg, 0, 1, BATCH, "train")),
            _batches(ImageFolderLoader(folder_cfg, 0, 1, BATCH, "train")))


def _crop_triples():
    rng = np.random.default_rng(7)
    n = 2000
    ws = rng.integers(1, 2049, n)
    hs = rng.integers(1, 2049, n)
    seeds = [int(s) for s in rng.integers(0, 2**63, n, dtype=np.uint64)
             * np.uint64(2) + np.uint64(1)]
    seeds[:40] = [2**64 - 1 - k for k in range(40)]  # near 2^64
    # Aspect ratios far outside [3/4, 4/3]: ten draws miss, so the
    # centre-crop fallback runs (both branches), plus degenerate sizes.
    extra = [(2000, 3), (3, 2000), (1, 1), (1, 2), (700, 9), (9, 700)]
    return ([(int(w), int(h), s) for w, h, s in zip(ws, hs, seeds)]
            + [(w, h, 2**64 - 5 - i) for i, (w, h) in enumerate(extra)])


def test_crop_sampler_equals_jax_python_and_native():
    triples = _crop_triples()
    got = [imagefolder._sample_crop(w, h, s) for w, h, s in triples]
    assert got == [jax_sample_crop(w, h, s) for w, h, s in triples]
    # The fallback branch ran: crops of the full height (or width).
    assert any(c[3] == 3 and c[2] < 2000 for c in got)
    assert native.available(), native.unavailable_reason()
    assert jax_native.available()
    assert [native.sample_crop(w, h, s) for w, h, s in triples] == [
        jax_native.sample_crop(w, h, s) for w, h, s in triples]


def test_native_decode_byte_equal_to_jax_build(data):
    assert native.library_path().exists()
    assert native.library_path().parent == REPO / "build" / "native"
    paths, _, _ = imagefolder.scan_imagefolder(
        os.path.join(data["folder"], "train"))
    seeds = np.arange(len(paths), dtype=np.uint64) * np.uint64(2**40) + 3
    for aug in (None, seeds):
        got, gok = native.decode_batch_uint8(paths, SIZE, n_threads=2,
                                             aug_seeds=aug)
        want, wok = jax_native.decode_batch_uint8(paths, SIZE, n_threads=2,
                                                  aug_seeds=aug)
        np.testing.assert_array_equal(gok, wok)
        np.testing.assert_array_equal(got, want)
        bad = sorted(os.path.basename(p) for p, ok in zip(paths, gok)
                     if not ok)
        assert bad == ["corrupt.jpg", "palette.bmp"]


def test_native_loader_against_pil_within_jax_bounds(data, capsys):
    """The port's native batch against its PIL batch on val (every row,
    unshuffled): ±1 per pixel on every row decoded without DCT scaling
    (JPEG, the BMP rescued by PIL, the corrupt file quarantined on both
    paths), except the RGBA PNG (see below); the DCT-scaled 300x200
    JPEG, the smooth q95 pattern on which the JAX package pins its
    bound, close in mean.
    The other DCT-scaled rows (noisy textures at 37x53 and 64x48) are
    held byte-equal to the JAX build only
    (``test_native_decode_byte_equal_to_jax_build``): on such content
    the draft decode differs from PIL by more than that mean bound, in
    both packages alike."""
    _, pil_cfg = _pair(data["folder"])
    nat_cfg = dataclasses.replace(pil_cfg, native_io=True)
    nat_loader = ImageFolderLoader(nat_cfg, 0, 1, BATCH, "val")
    assert nat_loader.decode_path == (
        f"native (webp {'yes' if native.has_webp() else 'no'})")
    pil_loader = ImageFolderLoader(pil_cfg, 0, 1, BATCH, "val")
    nat = np.concatenate([b.images for b in _batches(nat_loader)])
    pil = np.concatenate([b.images for b in _batches(pil_loader)])
    assert nat_loader.quarantined == pil_loader.quarantined == 1
    out = capsys.readouterr().out
    assert "palette.bmp not native-decodable" in out
    diff = np.abs(nat.astype(np.int16) - pil.astype(np.int16))
    exact = 0
    for path, d in zip(pil_loader.paths, diff):
        name = os.path.basename(path)
        if name == "corrupt.jpg":  # zeros on both paths
            assert not d.any()
            continue
        if name == "rgba.png":
            # libpng's simplified API composites the alpha onto black (in
            # linear light); PIL's convert("RGB") drops it. Both packages
            # alike: held byte-equal to the JAX build only.
            assert d.max() > 1
            continue
        with Image.open(path) as im:
            dct = im.format == "JPEG" and min(im.size) * 7 / 8 >= SIZE
        if not dct:
            assert d.max() <= 1, path
            exact += 1
        elif os.path.basename(path) == "big.jpg":
            assert d.mean() < DCT_MEAN_LEVELS and d.max() > 1
    assert exact >= 4  # three JPEGs and the BMP


def test_decode_line_names_why_native_is_not_used(data, monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(native, "unavailable_reason",
                        lambda: "g++ failed: jpeglib.h: No such file")
    _, cfg = _pair(data["folder"], native_io=True)
    loader = ImageFolderLoader(cfg, 0, 1, BATCH, "val")
    assert loader.decode_path == (
        "pil (native: g++ failed: jpeglib.h: No such file)")
    loader.close()


def test_wire_dtypes_bytes_and_bitwise_equal_input(data):
    _, cfg = _pair(data["folder"], augment=True)
    prep = make_input_prep(MEAN, STD)
    preps = {}
    for dtype, nbytes in zip(WIRE_DTYPES, (1, 2, 4)):
        loader = ImageFolderLoader(
            dataclasses.replace(cfg, transfer_dtype=dtype), 0, 1, BATCH,
            "train")
        batch = _batches(loader)[0]
        assert batch.images.itemsize == nbytes
        staged = _ready(torch.device("cpu"), _stage_batch(
            torch.device("cpu"), batch, False, None, None))
        preps[dtype] = prep(staged[0])
    assert preps["uint8"].dtype == torch.float32
    for dtype in WIRE_DTYPES:
        assert torch.equal(preps[dtype], preps["uint8"]), dtype
    u8 = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    for dtype, nbytes in zip(WIRE_DTYPES, (1, 2, 4)):
        assert to_wire(u8, dtype).itemsize == nbytes
    files = sorted((REPO / "imagent_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    bad = [str(f.relative_to(REPO)) for f in files
           for node in ast.walk(ast.parse(f.read_text()))
           if isinstance(node, ast.Import)
           and any(a.name.split(".")[0] == "ml_dtypes" for a in node.names)
           or isinstance(node, ast.ImportFrom)
           and (node.module or "").split(".")[0] == "ml_dtypes"]
    assert not bad, bad


def test_decode_modules_import_no_torch():
    code = ("import sys, imagent_tpu_torch.data.imagefolder,"
            " imagent_tpu_torch.data.tarshards;"
            "sys.exit('torch' in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_missing_pillow_exits_78_and_never_quarantines(data, tmp_path,
                                                       capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    assert main(_cli_args(data["folder"], tmp_path, "--no-native-io")) == 78
    out = capsys.readouterr().out
    assert "FATAL (fatal-config)" in out and "Pillow" in out
    assert "Epoch" not in out
    # Native decode needs PIL only for the files it cannot read (the
    # corrupt JPEG, the palette BMP): it refuses at the first instead of
    # zero-filling it.
    _, cfg = _pair(data["folder"], native_io=True)
    loader = ImageFolderLoader(cfg, 0, 1, BATCH, "val")
    with pytest.raises(imagefolder.DecoderMissing,
                       match="Pillow cannot be imported"):
        _batches(loader)
    assert loader.quarantined == 0
    assert "undecodable" not in capsys.readouterr().out


def _cli_args(root, tmp_path, *extra):
    return ["--backend", "cpu", "--dataset", "imagefolder", "--data-root",
            root, "--image-size", "32", "--num-classes", "4", "--no-bf16",
            "--batch-size", "4", "--workers", "0", "--epochs", "1",
            "--log-every", "0", "--save-model",
            "--ckpt-dir", str(tmp_path / "ckpt"),
            "--log-dir", str(tmp_path / "tb"), *extra]


@pytest.mark.parametrize("extra,decode", [
    ([], "decode: native (webp yes)"),
    (["--dataset", "tar", "--augment", "--no-native-io"], "decode: pil"),
])
def test_cli_trains_from_image_folder_and_tar(data, tmp_path, capsys, extra,
                                              decode):
    root = data["tar_port"] if "tar" in extra else data["folder"]
    if not native.has_webp():
        decode = decode.replace("webp yes", "webp no")
    assert main(_cli_args(root, tmp_path, *extra)) == 0
    out = capsys.readouterr().out
    assert re.findall(r"^decode: .*$", out, re.M) == [decode]
    losses = [float(x) for x in
              re.findall(r"^Epoch 1: .*? train loss (\S+)", out, re.M)]
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert (tmp_path / "ckpt" / "last.pt").exists()
    assert "1 unreadable file(s) quarantined" in out
