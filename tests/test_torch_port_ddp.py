"""The port's data parallelism across processes, against the JAX
package's ``shard_map`` step on a 2-device CPU mesh.

* ``train.py``/``parallel/collectives.py``: two gloo worker processes
  (this file's ``__main__``, which imports torch and the port only)
  each take 4 rows of every 8-row batch of a narrow BatchNorm ResNet
  (``num_filters`` 8, two BasicBlock stages, 16 px, 4 classes, float64
  compute as in ``tests/test_torch_port_resnet.py``, weights drawn from
  a numpy seed into the JAX model's tree and carried by
  ``resnet_params_from_jax``). Two SGD steps hold params, the running
  statistics (the replicas' mean, as the JAX step's ``pmean`` of
  ``batch_stats``) and metrics to JAX's, and the two ranks bitwise to
  each other; a batch poisoned on rank 1 only is skipped on both ranks;
  the eval step with a padded row on rank 1 gives JAX's ``psum``'d
  masked metrics; every train step makes two collectives whatever
  ``grad_accum`` is, and the eval step one.
* ``launch/slurm_gpu.sh`` + ``cluster.py`` + ``engine.py``: the launcher
  under an ``srun`` stub runs two CPU ranks of ``vit_debug`` at batch 4,
  which must equal one process at batch 8 (no BatchNorm, so the same
  global batch gives the same step); only rank 0 logs, checkpoints and
  writes TensorBoard.

Every subprocess is started at once, before the JAX reference compiles,
and has a timeout, so a rank that dies cannot leave its peer waiting in
``all_reduce``.
"""

import contextlib
import io
import os
import re
import stat
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, ROWS = 2, 4  # ranks, rows per rank
CLASSES, SIZE, FILTERS, STAGES = 4, 16, 8, (1, 1)
MEAN = STD = (0.5, 0.5, 0.5)
LR = 0.1
STEP_TOL = 1e-5
METRIC_TOL = 1e-4
TIMEOUT = 120  # seconds for any subprocess

_SRUN_STUB = """#!/bin/bash
# Stub srun: one task per rank on one node, per-task Slurm env.
pids=()
for ((i = 0; i < SLURM_NTASKS; i++)); do
  SLURM_PROCID=$i SLURM_NODEID=0 SLURM_LOCALID=$i \\
    "$@" > "${SRUN_LOG_DIR}/task${i}.log" 2>&1 &
  pids+=($!)
done
rc=0
for p in "${pids[@]}"; do wait "$p" || rc=1; done
exit $rc
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _scrubbed_env(**extra) -> dict:
    """The JAX/XLA settings of the test process and any outer Slurm job
    removed; the repo importable; one thread per rank."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS",
                        "IMAGENT_COORDINATOR_PORT")
           and not k.startswith("SLURM_")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra)
    return env


def _collect(procs: dict) -> dict:
    """``{name: (returncode, output)}``; a process still running past
    the timeout is killed (returncode None)."""
    out = {}
    try:
        for name, p in procs.items():
            try:
                text = p.communicate(timeout=TIMEOUT)[0]
                out[name] = (p.returncode, text)
            except subprocess.TimeoutExpired:
                out[name] = (None, "timed out")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


# ------------------------------------------------------------ the data


def _batches() -> dict:
    """Global batches of ``WORLD * ROWS`` rows: two train steps, a
    step poisoned in rank 1's rows only, and an eval batch whose last
    row (rank 1's) is padding. Images are float32 on the [0, 255] wire
    scale, so every train step has one dtype."""
    rng = np.random.default_rng(0)
    n = WORLD * ROWS

    def images():
        return rng.integers(0, 256, (n, SIZE, SIZE, 3)).astype(np.float32)

    def labels():
        return rng.integers(0, CLASSES, (n,)).astype(np.int32)

    train = [(images(), labels()) for _ in range(2)]
    poison = images()
    poison[ROWS + 1, 3, 5, 0] = np.nan
    mask = np.ones((n,), np.uint8)
    mask[-1] = 0
    return {"train": train, "poison": (poison, labels()),
            "eval": (images(), labels(), mask)}


def _rank_rows(array, rank):
    return array[rank * ROWS:(rank + 1) * ROWS]


# ------------------------------------------------------------ the worker


def _worker(rank: int, port: int, io_dir: str) -> None:
    """One rank: the port's steps on its rows of every batch, over a
    gloo group of ``WORLD``; the results go to ``rank<r>.pt``."""
    import copy

    import torch.distributed as dist

    from imagent_tpu_torch.models.resnet import ResNet
    from imagent_tpu_torch.parallel import collectives
    from imagent_tpu_torch.train import (
        create_train_state, make_eval_step, make_optimizer, make_train_step,
    )

    torch.set_num_threads(1)
    inp = torch.load(os.path.join(io_dir, "input.pt"), weights_only=False)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=WORLD, rank=rank)
    group = dist.group.WORLD
    try:
        model = ResNet(STAGES, False, num_classes=CLASSES,
                       num_filters=FILTERS, dtype=torch.float64)
        model.load_state_dict(inp["state_dict"], strict=True)
        opt = make_optimizer(0.9, 1e-4, "sgd")
        state = create_train_state(model, opt)
        lr = torch.tensor(LR)

        def rows(*arrays):
            return [torch.from_numpy(_rank_rows(a, rank)) for a in arrays]

        step = make_train_step(opt, MEAN, STD, group=group)
        collectives.reset_calls()
        metrics = []
        for images, labels in inp["batches"]["train"]:
            state, m = step(state, *rows(images, labels), lr)
            metrics.append(m.clone())
        after_two = copy.deepcopy(state.model.state_dict())
        state, m = step(state, *rows(*inp["batches"]["poison"]), lr)
        metrics.append(m.clone())
        calls = {"train": dict(collectives.CALLS)}

        collectives.reset_calls()
        evaluated = make_eval_step(MEAN, STD, group=group)(
            state, *rows(*inp["batches"]["eval"]))
        calls["eval"] = dict(collectives.CALLS)

        collectives.reset_calls()
        accum_step = make_train_step(opt, MEAN, STD, grad_accum=2,
                                     group=group)
        accum_step(create_train_state(copy.deepcopy(model), opt),
                   *rows(*inp["batches"]["train"][0]), lr)
        calls["train_accum2"] = dict(collectives.CALLS)
    finally:
        dist.destroy_process_group()
    torch.save({"metrics": metrics, "after_two": after_two,
                "after_poison": state.model.state_dict(),
                "step": int(state.step), "eval": evaluated, "calls": calls,
                "jax_imported": sorted(m for m in sys.modules
                                       if m.split(".")[0] in ("jax", "flax",
                                                              "imagent_tpu"))},
               os.path.join(io_dir, f"rank{rank}.pt"))


# ------------------------------------------------------------ the reference


def _jax_init():
    """``(params, batch_stats)`` in the Flax tree of the narrow ResNet
    (``jax.eval_shape`` of its ``init``), drawn from a numpy seed: He
    normal kernels, BatchNorm scales, biases and running statistics away
    from (1, 0, 0, 1), so that every term of the step shows."""
    import jax
    import jax.numpy as jnp

    from imagent_tpu.models.resnet import BasicBlock, ResNet
    model = ResNet(stage_sizes=STAGES, block_cls=BasicBlock,
                   num_classes=CLASSES, num_filters=FILTERS)
    shapes = jax.eval_shape(lambda k: model.init(
        k, jnp.zeros((1, SIZE, SIZE, 3)), train=False), jax.random.key(0))
    rng = np.random.default_rng(1)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan = int(np.prod(leaf.shape[:-2] or (1,))) * leaf.shape[-1]
            v = rng.normal(size=leaf.shape) * np.sqrt(2.0 / fan)
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, leaf.shape)
        else:  # bias, mean
            v = rng.normal(size=leaf.shape) * 0.1
        return v.astype(np.float32)
    v = jax.tree_util.tree_map_with_path(draw, shapes)
    return v["params"], v["batch_stats"]


def _fast_compile(jitted, *args):
    """``jitted`` compiled for ``args`` at LLVM optimisation level 0:
    the same program, in a third of the compile time."""
    return jitted.lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _jax_reference(params, stats, batches) -> dict:
    """The JAX step on a 2-device mesh over the same global batches:
    metrics of the three train steps, the state after two and after
    the poisoned one, and the eval vector."""
    import jax
    import jax.numpy as jnp

    from imagent_tpu.cluster import make_mesh
    from imagent_tpu.models.resnet import BasicBlock, ResNet
    from imagent_tpu.train import (
        TrainState, make_eval_step, make_optimizer, make_train_step,
        replicate_state, shard_batch,
    )
    with jax.enable_x64(True):
        mesh = make_mesh(devices=jax.devices()[:WORLD])
        model = ResNet(stage_sizes=STAGES, block_cls=BasicBlock,
                       num_classes=CLASSES, num_filters=FILTERS,
                       dtype=jnp.float64)
        opt = make_optimizer(0.9, 1e-4, "sgd")
        # float64 statistics from the start: the step's output has the
        # compute type, and one input dtype means one compile.
        state = replicate_state(TrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=jax.tree.map(lambda a: a.astype(np.float64), stats),
            opt_state=opt.init(params)), mesh)
        lr = np.float32(LR)
        steps = [(*shard_batch(mesh, *b), lr)
                 for b in (*batches["train"], batches["poison"])]
        step = _fast_compile(make_train_step(
            model, opt, mesh, mean=MEAN, std=STD, weight_decay=1e-4),
            state, *steps[0])
        metrics = []
        for i, args in enumerate(steps):
            state, m = step(state, *args)
            metrics.append(np.asarray(m))
            if i == 1:
                after_two = jax.device_get((state.params,
                                            state.batch_stats))
        after_poison = jax.device_get((state.params, state.batch_stats))
        eval_args = (state, *shard_batch(mesh, *batches["eval"]))
        evaluated = _fast_compile(make_eval_step(
            model, mesh, mean=MEAN, std=STD), *eval_args)(*eval_args)
        return {"metrics": metrics, "after_two": after_two,
                "after_poison": after_poison,
                "eval": np.asarray(evaluated)}


# ------------------------------------------------------------ the runs


def _launcher_args(tmp, batch: int) -> list:
    return ["--backend=cpu", "--arch=vit_debug", "--dataset", "synthetic",
            "--image-size", str(SIZE), "--num-classes", str(CLASSES),
            "--no-bf16", "--batch-size", str(batch), "--synthetic-size", "32",
            "--workers", "0", "--epochs", "1", "--log-every", "0",
            "--save-model", "--ckpt-dir", os.path.join(tmp, "ckpt"),
            "--log-dir", os.path.join(tmp, "tb")]


def _start_launcher(tmp: str) -> subprocess.Popen:
    """``slurm_gpu.sh`` under the ``srun`` stub: 2 CPU ranks at batch 4.
    The stub's ``python`` runs this interpreter."""
    bindir = os.path.join(tmp, "bin")
    os.makedirs(bindir)
    with open(os.path.join(bindir, "srun"), "w") as f:
        f.write(_SRUN_STUB)
    os.chmod(os.path.join(bindir, "srun"), stat.S_IRWXU)
    with open(os.path.join(bindir, "python"), "w") as f:
        f.write(f'#!/bin/bash\nexec "{sys.executable}" "$@"\n')
    os.chmod(os.path.join(bindir, "python"), stat.S_IRWXU)
    env = _scrubbed_env(
        PATH=bindir + os.pathsep + os.environ.get("PATH", ""),
        SRUN_LOG_DIR=tmp, SLURM_SUBMIT_DIR=REPO, SLURM_JOB_NUM_NODES="1",
        SLURM_NTASKS=str(WORLD), SLURM_JOB_NODELIST="127.0.0.1",
        IMAGENT_COORDINATOR_PORT=str(_free_port()))
    return subprocess.Popen(
        ["bash", os.path.join(REPO, "imagent_tpu_torch", "launch",
                              "slurm_gpu.sh"), *_launcher_args(tmp, ROWS)],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of this module, the subprocesses overlapping the JAX
    reference and the in-process 1-process run."""
    from imagent_tpu_torch.__main__ import main
    from imagent_tpu_torch.compat import resnet_params_from_jax

    launch_dir = str(tmp_path_factory.mktemp("launch"))
    io_dir = str(tmp_path_factory.mktemp("ddp"))
    procs = {"launcher": _start_launcher(launch_dir)}
    try:
        params, stats = _jax_init()
        batches = _batches()
        torch.save({"state_dict": resnet_params_from_jax(params, stats),
                    "batches": batches}, os.path.join(io_dir, "input.pt"))
        port = _free_port()
        for rank in range(WORLD):
            procs[f"rank{rank}"] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "worker",
                 str(rank), str(port), io_dir],
                cwd=REPO, env=_scrubbed_env(), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
        ref = _jax_reference(params, stats, batches)
        one_dir = str(tmp_path_factory.mktemp("one"))
        out = io.StringIO()
        with pytest.MonkeyPatch.context() as mp:
            for k in list(os.environ):
                if k.startswith("SLURM_"):
                    mp.delenv(k)
            with contextlib.redirect_stdout(out):
                rc = main(_launcher_args(one_dir, WORLD * ROWS))
        assert rc == 0, out.getvalue()
    finally:
        done = _collect(procs)
    for r in range(WORLD):  # the launcher's ranks write these logs
        with open(os.path.join(launch_dir, f"task{r}.log")) as f:
            done["launcher"] = (done["launcher"][0],
                                done["launcher"][1] + f.read())
    for name, (code, text) in done.items():
        assert code == 0, f"{name} exited {code}:\n{text}"
    ranks = [torch.load(os.path.join(io_dir, f"rank{r}.pt"),
                        weights_only=False) for r in range(WORLD)]
    return {"ref": ref, "ranks": ranks, "launch_dir": launch_dir, "one_dir": one_dir,
            "one_out": out.getvalue()}


def _want_state(params, stats) -> dict:
    from imagent_tpu_torch.compat import resnet_params_from_jax
    return resnet_params_from_jax(params, stats)


def test_two_rank_sgd_steps_match_jax_and_ranks_agree(runs):
    want = _want_state(*runs["ref"]["after_two"])
    r0, r1 = runs["ranks"]
    assert not r0["jax_imported"] and not r1["jax_imported"]
    for i in range(2):
        np.testing.assert_allclose(r0["metrics"][i].numpy(),
                                   runs["ref"]["metrics"][i],
                                   rtol=METRIC_TOL, atol=METRIC_TOL)
        assert torch.equal(r0["metrics"][i], r1["metrics"][i])
    got = r0["after_two"]
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                   rtol=STEP_TOL, atol=STEP_TOL,
                                   err_msg=name)
        assert torch.equal(got[name], r1["after_two"][name]), name


def test_batch_poisoned_on_one_rank_is_skipped_on_both(runs):
    ref = runs["ref"]
    np.testing.assert_array_equal(ref["metrics"][2][:4], 0.0)
    want = _want_state(*ref["after_poison"])
    for r in runs["ranks"]:
        np.testing.assert_array_equal(r["metrics"][2][:4].numpy(), 0.0)
        assert r["step"] == 3
        for name, before in r["after_two"].items():
            assert torch.equal(r["after_poison"][name], before), name
            np.testing.assert_allclose(r["after_poison"][name].numpy(),
                                       want[name].numpy(), rtol=STEP_TOL,
                                       atol=STEP_TOL, err_msg=name)


def test_eval_with_a_padded_row_matches_jax_psum(runs):
    r0, r1 = runs["ranks"]
    assert float(r0["eval"][3]) == WORLD * ROWS - 1
    np.testing.assert_allclose(r0["eval"].numpy(), runs["ref"]["eval"],
                               rtol=METRIC_TOL, atol=METRIC_TOL)
    assert torch.equal(r0["eval"], r1["eval"])


@pytest.mark.parametrize("phase,want", [
    ("train", {"pmean": 3, "psum": 3}),  # three steps: two each
    ("train_accum2", {"pmean": 1, "psum": 1}),
    ("eval", {"pmean": 0, "psum": 1}),
])
def test_collectives_per_step(runs, phase, want):
    for r in runs["ranks"]:
        assert r["calls"][phase] == want


def _epoch_loss(text: str) -> float:
    losses = re.findall(r"^Epoch 1: .*? train loss (\S+)", text, re.M)
    assert len(losses) == 1, text
    return float(losses[0])


def test_launcher_two_ranks_equal_one_process(runs):
    launch, one = runs["launch_dir"], runs["one_dir"]
    with open(os.path.join(launch, "task0.log")) as f:
        log0 = f.read()
    with open(os.path.join(launch, "task1.log")) as f:
        log1 = f.read()
    assert "[rank 0/2]" in log0 and "world 2 over gloo" in log0
    assert "data_parallel 2 global_batch 8" in log0
    assert "[rank 1/2]" in log1 and "Epoch 1:" not in log1
    assert abs(_epoch_loss(log0) - _epoch_loss(runs["one_out"])) <= 1e-5

    def last(d):
        return torch.load(os.path.join(d, "ckpt", "last.pt"),
                          weights_only=True)
    two, single = last(launch), last(one)
    for name, w in single["model"].items():
        np.testing.assert_allclose(two["model"][name].numpy(), w.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    import json
    with open(os.path.join(launch, "ckpt", "last_meta.json")) as f:
        meta = json.load(f)
    assert (meta["process_count"], meta["data_parallel"],
            meta["global_batch"]) == (2, 2, 8)
    # Only rank 0 wrote TensorBoard events: one pid in the file names.
    pids = {name.split(".")[-2] for _, _, names in
            os.walk(os.path.join(launch, "tb")) for name in names
            if name.startswith("events.out.tfevents")}
    assert len(pids) == 1, pids


@pytest.mark.parametrize("extra,why", [
    (["--dp", "2"], "--dp 2 does not match the world: 1 process"),
    (["--global-batch", "12"], "--global-batch 12 is not divisible"),
    (["--global-batch", "16", "--grad-accum", "2"], "DERIVED"),
])
def test_world_and_global_batch_refusals_exit_78(tmp_path, capsys,
                                                 monkeypatch, extra, why):
    from imagent_tpu_torch.__main__ import main
    for k in list(os.environ):
        if k.startswith("SLURM_"):
            monkeypatch.delenv(k)
    assert main(_launcher_args(str(tmp_path), 8) + extra) == 78
    assert why in capsys.readouterr().out


def test_local_rank_without_a_card_exits_78(tmp_path, capsys,
                                            monkeypatch):
    """``--backend gpu`` never shares a card or falls back to the CPU: a
    task whose local rank has no card of its own is refused before any
    group is formed (the CUDA queries faked: one card visible)."""
    from imagent_tpu_torch.__main__ import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for k, v in {"SLURM_JOB_NUM_NODES": "1", "SLURM_NTASKS": "2",
                 "SLURM_PROCID": "1", "SLURM_NODEID": "0",
                 "SLURM_LOCALID": "1",
                 "SLURM_JOB_NODELIST": "127.0.0.1"}.items():
        monkeypatch.setenv(k, v)
    args = _launcher_args(str(tmp_path), 4)
    args[args.index("--backend=cpu")] = "--backend=nccl"
    assert main(args) == 78
    assert "local rank 1 has no CUDA device of its own" in (
        capsys.readouterr().out)
    assert not torch.distributed.is_initialized()


def test_global_batch_derives_grad_accum():
    from imagent_tpu_torch.config import Config
    from imagent_tpu_torch.engine import batch_geometry
    assert batch_geometry(Config(batch_size=4, grad_accum=3), 2) == (24, 3)
    assert batch_geometry(Config(batch_size=4, global_batch=16), 2) == (16, 2)
    assert batch_geometry(Config(batch_size=4, global_batch=16, dp=4),
                          4) == (16, 1)


if __name__ == "__main__":
    if sys.argv[1:2] != ["worker"]:
        sys.exit("usage: test_torch_port_ddp.py worker <rank> <port> <dir>")
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
