"""The port's entry point and package rules: the config surface against
the JAX package's, the refusal of flags this slice does not port, the
CUDA-by-default device rule, the import boundary (no JAX, nothing of
``imagent_tpu``), and a CPU end-to-end run with checkpoints, TensorBoard
files and ``--resume``."""

import ast
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from imagent_tpu.config import Config as JaxConfig
from imagent_tpu.config import build_parser as jax_parser
from imagent_tpu_torch.__main__ import main
from imagent_tpu_torch.config import PORTED, Config, build_parser, check_ported

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "imagent_tpu")


def _cpu_args(tmp_path, *extra):
    return ["--backend", "cpu", "--arch", "vit_debug", "--attn", "flash",
            "--dataset", "synthetic", "--image-size", "16",
            "--num-classes", "4", "--no-bf16", "--batch-size", "8",
            "--synthetic-size", "64", "--workers", "0", "--log-every", "0",
            "--ckpt-dir", str(tmp_path / "ckpt"),
            "--log-dir", str(tmp_path / "tb"), *extra]


def test_config_fields_flags_and_defaults_match_jax():
    ours = {f.name: getattr(Config(), f.name)
            for f in dataclasses.fields(Config)}
    theirs = {f.name: getattr(JaxConfig(), f.name)
              for f in dataclasses.fields(JaxConfig)}
    assert set(ours) == set(theirs)
    differ = {k for k in ours if ours[k] != theirs[k]}
    assert differ == {"backend"} and ours["backend"] == "gpu"
    assert PORTED <= set(ours)

    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings}
    assert flags(build_parser()) == flags(jax_parser())


@pytest.mark.parametrize("extra", [
    ["--arch", "resnet50", "--remat"], ["--fsdp"], ["--optimizer", "nadam"],
    ["--dataset", "imagefolder"], ["--mixup", "0.2"], ["--remat"],
    ["--backend", "tpu"], ["--no-telemetry"],
    ["--arch", "convnext_tiny", "--remat"],
])
def test_unported_flags_exit_78(tmp_path, capsys, extra):
    assert main(_cpu_args(tmp_path, *extra)) == 78
    out = capsys.readouterr().out
    assert "FATAL (fatal-config)" in out


def test_default_backend_needs_cuda(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    args = [a for a in _cpu_args(tmp_path) if a not in ("--backend", "cpu")]
    assert main(args) == 78
    assert "no CUDA device" in capsys.readouterr().out


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = sorted((REPO / "imagent_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    bad = [(str(f.relative_to(REPO)), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    code = ("import sys, imagent_tpu_torch.engine, imagent_tpu_torch.__main__,"
            " imagent_tpu_torch.models.convnext,"
            " imagent_tpu_torch.models.resnet,"
            " imagent_tpu_torch.ops.fused_block,"
            " imagent_tpu_torch.ops.fused_mlp,"
            " imagent_tpu_torch.parallel.collectives;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _epochs(out: str) -> dict:
    return {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"^Epoch (\d+): .*? train loss (\S+)", out, re.M)}


def test_cpu_run_trains_checkpoints_and_resumes(tmp_path, capsys):
    assert main(_cpu_args(tmp_path, "--epochs", "2", "--save-model")) == 0
    losses = _epochs(capsys.readouterr().out)
    assert set(losses) == {1, 2} and losses[2] < losses[1]
    for name in ("best.pt", "best_meta.json", "last.pt", "last_meta.json"):
        assert (tmp_path / "ckpt" / name).exists(), name
    assert any(p.name.startswith("events.out.tfevents")
               for p in (tmp_path / "tb").rglob("*"))

    assert main(_cpu_args(tmp_path, "--epochs", "3", "--save-model",
                          "--resume")) == 0
    out = capsys.readouterr().out
    assert "resumed from epoch 2" in out
    assert set(_epochs(out)) == {3}


def test_convnext_fused_cpu_run_starts(tmp_path, capsys):
    """ConvNeXt-T at full width and depth with --fused-mlp on: the plan
    line fuses all 18 blocks (their plain versions on the CPU) and an
    epoch trains to a finite loss."""
    args = [a if a != "vit_debug" else "convnext_tiny"
            for a in _cpu_args(tmp_path)]
    args[args.index("--image-size") + 1] = "32"
    args[args.index("--batch-size") + 1] = "2"
    args[args.index("--synthetic-size") + 1] = "4"
    assert main(args + ["--fused-mlp", "on", "--epochs", "1"]) == 0
    out = capsys.readouterr().out
    assert ("fused-mlp on: C=96 fused, C=192 fused, C=384 fused, "
            "C=768 fused (18/18 blocks fused)") in out
    losses = _epochs(out)
    assert set(losses) == {1} and np.isfinite(losses[1])


def test_default_config_is_ported():
    """The default command's arch (resnet18), image size, optimizer and
    every other default pass the port's check; only the default dataset
    (imagefolder, not yet ported) needs --dataset synthetic."""
    cfg = Config()
    assert (cfg.arch, cfg.image_size, cfg.optimizer) == ("resnet18", 448,
                                                         "sgd")
    check_ported(dataclasses.replace(cfg, dataset="synthetic"))
    with pytest.raises(ValueError, match="--dataset imagefolder"):
        check_ported(cfg)


def test_default_resnet18_cpu_run_checkpoints_bn_buffers_and_resumes(
        tmp_path, capsys):
    """No --arch: ResNet-18 at full width on 32 px images trains two
    epochs to a finite loss; best/last checkpoints carry the BatchNorm
    running statistics, and --resume restores them."""
    args = ["--backend", "cpu", "--dataset", "synthetic", "--image-size",
            "32", "--num-classes", "4", "--no-bf16", "--batch-size", "4",
            "--synthetic-size", "16", "--workers", "0", "--log-every", "0",
            "--save-model", "--ckpt-dir", str(tmp_path / "ckpt"),
            "--log-dir", str(tmp_path / "tb")]
    assert main(args + ["--epochs", "2"]) == 0
    losses = _epochs(capsys.readouterr().out)
    assert set(losses) == {1, 2} and all(np.isfinite(list(losses.values())))
    for name in ("best.pt", "last.pt"):
        model = torch.load(tmp_path / "ckpt" / name, weights_only=True)[
            "model"]
        assert "layer4_block1.BatchNorm_1.running_var" in model
        assert not any(k.endswith("num_batches_tracked") for k in model)
    last = torch.load(tmp_path / "ckpt" / "last.pt", weights_only=True)
    stats = {k: v for k, v in last["model"].items() if "running" in k}
    assert any(not torch.equal(v, torch.ones_like(v))
               for k, v in stats.items() if k.endswith("running_var"))

    from imagent_tpu_torch import checkpoint as ckpt_lib
    from imagent_tpu_torch.models import create_model
    from imagent_tpu_torch.train import create_train_state, make_optimizer
    state = create_train_state(create_model("resnet18", 4),
                               make_optimizer(name="sgd"))
    meta = ckpt_lib.restore(str(tmp_path / "ckpt"), ckpt_lib.LAST, state)
    assert meta["epoch"] == 1
    restored = state.model.state_dict()
    for k, v in stats.items():
        assert torch.equal(restored[k], v), k

    assert main(args + ["--epochs", "3", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from epoch 2" in out and set(_epochs(out)) == {3}


def test_best_is_written_only_on_strict_improvement(tmp_path, capsys,
                                                    monkeypatch):
    """BEST as the JAX engine decides it: a save only when top-1 strictly
    improves on the best so far, which starts at 0. Every eval here
    reports top-1 = top-5 = 0 by construction (the real eval runs, its
    accuracies are then zeroed), so the run writes LAST and no BEST, and
    its summary is what the JAX package's ``final_summary`` prints for
    the best it never moved from: (epoch -1, 0.0, 0.0)."""
    from imagent_tpu.utils.logging import TrainLogger as JaxLogger
    from imagent_tpu_torch import engine

    real_evaluate = engine.evaluate

    def zero_accuracy(*args, **kwargs):
        metrics, seconds = real_evaluate(*args, **kwargs)
        return {**metrics, "top1": 0.0, "top5": 0.0}, seconds

    monkeypatch.setattr(engine, "evaluate", zero_accuracy)
    assert main(_cpu_args(tmp_path, "--epochs", "2", "--save-model")) == 0
    out = capsys.readouterr().out
    assert (tmp_path / "ckpt" / "last.pt").exists()
    assert not (tmp_path / "ckpt" / "best.pt").exists()
    assert not (tmp_path / "ckpt" / "best_meta.json").exists()

    JaxLogger(str(tmp_path / "jax_tb"), True,
              tensorboard=False).final_summary(-1, 0.0, 0.0, 0.0)
    want = capsys.readouterr().out.splitlines()[:2]
    assert want == ["Best top-1: 0.000 (epoch 0)", "Best top-5: 0.000"]
    assert re.findall(r"^Best top-[15]: .*$", out, re.M) == want


def test_startup_line_names_default_on_subsystems_not_run(tmp_path, capsys):
    """A default run names, once, the subsystems the JAX package runs by
    default (True in its ``Config``) that the port does not: derived
    from ``Config`` and ``PORTED``, and it refuses nothing."""
    on = {f.name for f in dataclasses.fields(JaxConfig)
          if getattr(JaxConfig(), f.name) is True} - PORTED
    assert on == {"telemetry", "aot_steps", "async_ckpt", "native_io",
                  "chipacct"}
    assert main(_cpu_args(tmp_path, "--epochs", "1")) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("not run by this port")]
    assert lines == ["not run by this port (on by default in the JAX "
                     "package): native_io, telemetry, aot_steps, "
                     "async_ckpt, chipacct"]
