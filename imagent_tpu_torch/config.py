"""Configuration: CLI flags + typed dataclass (PyTorch port).

A copy of ``imagent_tpu/config.py``: every field and flag keeps its name
and default, so the two packages read the same command lines. The one
stated difference is ``backend``: ``gpu`` (the default, CUDA) or ``cpu``.
Field comments describe the JAX package's features; this port implements
the subset in ``PORTED``, and ``check_ported`` refuses any other flag
given a non-default value (see ``unported_fields``).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Sequence


@dataclasses.dataclass
class Config:
    # ---- reference flag surface (imagenet.py:435-450) ----
    seed: int = 0
    backend: str = "gpu"  # gpu (CUDA, the default) | cpu; nccl/gloo alias
    batch_size: int = 128  # per data-parallel replica, as in the reference
    epochs: int = 100
    lr: float = 0.1
    save_model: bool = False

    # ---- promoted hard-coded constants (reference defaults) ----
    arch: str = "resnet18"  # imagenet.py:312
    image_size: int = 448  # imagenet.py:281
    num_classes: int = 1000
    mean: Sequence[float] = (0.5, 0.5, 0.5)  # imagenet.py:283
    std: Sequence[float] = (0.5, 0.5, 0.5)  # imagenet.py:283
    data_root: str = "../data/imagenet"  # imagenet.py:287-289
    momentum: float = 0.9  # imagenet.py:325
    weight_decay: float = 1e-4  # imagenet.py:325
    # sgd (reference parity) | nadam (the optimizer the reference's dead
    # `custom_optimizers` import pointed at, imagenet.py:36) | adamw |
    # lars (large-batch SGD).
    optimizer: str = "sgd"
    lr_decay_period: int = 30  # imagenet.py:158
    lr_decay_factor: float = 0.1  # imagenet.py:158
    workers: int = 10  # imagenet.py:352 (0 = in-process serial decode)
    native_io: bool = True  # C++ threaded decode (imagent_tpu/native)
    # Decode-offload endpoints, "host:port[,host:port...]" ("" = off):
    # non-training CPU hosts running `python -m imagent_tpu.data.serve`
    # decode this run's batches (same stream contract, shared-nothing)
    # and ship ready uint8 batches over the wire to the staging queue
    # (data/offload.py). A dead/unreachable service degrades to local
    # decode with a counted fallback, never a dead run. imagefolder/tar
    # datasets only.
    decode_offload: str = ""
    # Alert when an epoch's input-wait fraction (step-loop time blocked
    # on the staging queue / epoch wall) exceeds this: master WARN +
    # `input_wait_alert` telemetry event + status.json surface, with
    # the slowest host named via the pod straggler flags (ROADMAP item
    # 5's alerting clause). 0 disables.
    input_wait_alert: float = 0.10
    log_dir: str = "runs/imagent_tpu"  # imagenet.py:363 (same default)
    ckpt_dir: str = "checkpoints"  # imagenet.py:392 (file → dir for Orbax)

    # ---- new capabilities (absent in reference) ----
    resume: bool = False  # full-state resume (reference has none, SURVEY §5)
    # Run validation only (on the resumed/initialized params), no training.
    eval_only: bool = False
    # Initialize params from a torch .pt state_dict (the reference's
    # checkpoint format, imagenet.py:392, DDP "module." prefix handled) —
    # converted via compat/torch_weights.py. ResNet + ViT +
    # ConvNeXt archs.
    init_from_torch: str = ""
    # Write the final params as a torchvision-named torch .pt
    # state_dict at run end (the inverse of --init-from-torch; all
    # three families) — train here, serve/analyze in torch.
    export_torch: str = ""
    # RandomResizedCrop + hflip train augmentation. The reference has NONE
    # (SURVEY §0: Resize+Normalize only, hence its 63% top-1); required for
    # the north-star accuracy config (BASELINE.md).
    augment: bool = False
    dataset: str = "imagefolder"  # imagefolder | tar | synthetic
    synthetic_size: int = 2048  # images per epoch in synthetic mode
    bf16: bool = True  # bfloat16 compute on the MXU
    # Wire dtype of image batches, decode → IPC → prefetch queue → H2D
    # (data/pipeline.py Batch contract). All three carry the RAW
    # [0, 255] pixel scale — dequantize+normalize run in-graph — so
    # this knob changes bytes on the wire and nothing else:
    #   uint8   (default) 1 byte/pixel, 4× leaner than the reference's
    #           host-normalized float32 path (imagenet.py:280-283);
    #   bf16    2 bytes/pixel (the old --input-bf16 behavior's slot);
    #   float32 4 bytes/pixel, the A/B parity reference.
    transfer_dtype: str = "uint8"
    # Device prefetch staging depth (data/prefetch.py): how many global
    # batches are staged on-device ahead of the running step. 2 = double
    # buffering; deeper only adds HBM pressure unless H2D is bursty.
    prefetch_depth: int = 2
    warmup_epochs: int = 0  # linear LR warmup (0 = reference behavior)
    label_smoothing: float = 0.0  # CE smoothing (0 = reference behavior)
    # In-graph batch augmentation (ops/mixing.py): Beta(a, a) mixing
    # strength; 0 = off = reference behavior. Both > 0 = coin flip per
    # batch between the two modes.
    mixup: float = 0.0
    cutmix: float = 0.0
    # Parameter EMA maintained inside the train step; eval runs on the
    # averaged weights when > 0 (train.TrainState.ema_params).
    ema_decay: float = 0.0
    # In-graph photometric jitter (ops/jitter.py): brightness /
    # contrast / saturation strengths, torchvision factor semantics.
    # All 0 = off = reference behavior.
    color_jitter: Sequence[float] = (0.0, 0.0, 0.0)
    # jax.checkpoint each residual/encoder block: recompute activations
    # on the backward pass — ~33% more FLOPs for O(depth) less HBM.
    remat: bool = False
    # ResNet stem variant: "v1" (torchvision-exact 7x7/s2; required for
    # --init-from-torch) or "s2d" (MLPerf-style space-to-depth 4x4/s1
    # stem — measured lever table in docs/ROOFLINE.md).
    stem: str = "v1"
    # Micro-batches accumulated per optimizer step inside the compiled
    # train step: effective global batch = batch_size * data_parallel * K.
    grad_accum: int = 1
    schedule: str = "step"  # step | cosine
    eval_every: int = 1  # validate every N epochs
    log_every: int = 50  # step-level stdout cadence on process 0
    # Whole-run jax.profiler trace (SURVEY §5 tracing). Prefer
    # --profile-at-step: a full-run trace of a long job is unloadably
    # large and mostly steady-state repetition.
    profile: bool = False
    # ---- telemetry (imagent_tpu/telemetry/) ----
    # Goodput accounting + step-time percentiles + pod aggregation,
    # written as TB scalars and runs/<run>/telemetry.jsonl. On by
    # default: the per-step cost is two host timestamps (no device
    # syncs); --no-telemetry is the kill switch.
    telemetry: bool = True
    # Capture a jax.profiler trace for M global steps starting at step
    # N ("N" or "N:M", M defaults to 10). Resume-aware: global step =
    # epoch * steps_per_epoch + step. Mutually exclusive with
    # --profile.
    profile_at_step: str = ""
    # A host is flagged as a straggler when its per-epoch input-wait or
    # step-time p95 exceeds this multiple of the pod median (see
    # telemetry/aggregate.py for the absolute floors).
    straggler_factor: float = 2.0
    # Persistent XLA compilation cache dir ("" = off): restarted/resumed
    # runs skip the first-step compile (~minutes for big models).
    compile_cache: str = ""
    # One-compile AOT startup (compilecache.py): compile each step
    # executable once via lower().compile(), share it with the chip
    # accountant, and (with --compile-cache) serialize it for warm
    # restarts. False = legacy jit-on-first-step.
    aot_steps: bool = True
    check_nans: bool = False  # debug flag (SURVEY §5 sanitizers)
    # Asynchronous per-epoch LAST checkpointing (checkpoint.save_async):
    # the step loop blocks only for the device→host snapshot;
    # serialization + rotation + manifest hashing run on a background
    # committer thread whose verdict is pod-agreed at the next epoch
    # boundary. --no-async-ckpt restores the fully synchronous save —
    # the bench-smoke baseline the telemetry regression compares
    # against.
    async_ckpt: bool = True
    # Checkpoint format family. "snapshot" (default): DP/replicated
    # states use the flat snapshot format and host-sharded states
    # (multi-host FSDP/TP/ZeRO-1) the SHARDED snapshot format — both
    # collective-free on the commit path, both restorable onto any
    # topology. "orbax" is the legacy escape hatch: sharded states go
    # through the collective Orbax gather/save (no emergency salvage,
    # no cross-topology sharded resume) — keep only for reading back
    # with external Orbax tooling.
    ckpt_format: str = "snapshot"

    # ---- model-health observability (telemetry/health.py) ----
    # In-graph health stats: the train step appends global grad-norm,
    # param-norm and update-ratio to the replicated metric vector
    # (train.HEALTH_FIELDS), consumed on the lagged frontier — zero
    # added host syncs. --no-health-stats is the kill switch.
    health_stats: bool = True
    # Divergence early-warning: an observation exceeding this factor x
    # its trailing EWMA baseline (grad-norm and update-ratio) is a
    # health anomaly — warned, logged as a health_anomaly telemetry
    # event, and (with --health-rollback) fed to the rollback
    # machinery BEFORE the non-finite guard can fire. 0 disables.
    health_grad_spike: float = 10.0
    # Same, for the per-step train loss. Deliberately loose: 3-4x loss
    # excursions are routine in early training (measured on the CPU
    # drill geometry); a 10x spike over the trailing EWMA is a
    # genuinely diverging run, not noise.
    health_loss_spike: float = 10.0
    # Clean steps the EWMA baselines must absorb before any verdict.
    health_warmup_steps: int = 20
    # Roll back to the last good checkpoint on a health anomaly (off =
    # warn + telemetry only).
    health_rollback: bool = False
    # Crash flight recorder (telemetry/flightrec.py): ring of the last
    # N lagged step/health records, flushed as
    # <log_dir>/flightrec.<rank>.json on every fatal exit path and
    # referenced from the tombstone. 0 disables.
    flightrec_steps: int = 256

    # ---- SLO engine + OpenMetrics exporter ----
    # Declarative run-health objectives (telemetry/slo.py), evaluated
    # against every epoch's telemetry record on the master: "off"
    # (default), "default" (the built-in production spec), or a JSON
    # spec file path. Breaches become slo_breach telemetry events, TB
    # markers, status.json fields and loud prints; `python -m
    # imagent_tpu.telemetry slo <run_dir>` replays the evaluation
    # offline (`make slo-check`).
    slo: str = "off"
    # Live OpenMetrics/Prometheus endpoint (telemetry/export.py):
    # process 0 serves GET /metrics on this port with goodput phases,
    # step percentiles, health EWMAs, HBM, pod/per-peer heartbeat
    # state, checkpoint commit geometry, SLO breach counters and
    # compile-event counts — refreshed at epoch boundaries (the same
    # state status.json records). 0 = off.
    metrics_port: int = 0
    # Chip accountant (telemetry/chipacct.py): capture the compiled
    # step's XLA cost/memory analyses once at startup, attribute the
    # TrainState's per-device bytes by component, derive zero-step-cost
    # MFU from the goodput partition, and run the OOM preflight (a
    # modeled peak over the known HBM limit refuses the run with
    # fatal-config exit 78 before step 0). Costs one extra startup
    # compile per captured executable (AOT products don't land in the
    # jit cache); False skips capture AND the preflight.
    chipacct: bool = True
    # Preflight HBM budget override, GiB per device: stands in where
    # the backend reports no memory limit (CPU) or the operator wants
    # a tighter envelope than the hardware's. 0 = use
    # device.memory_stats() when available, else preflight reports
    # "unknown-limit" and never refuses.
    hbm_budget_gb: float = 0.0
    # Peak bf16 TFLOP/s per chip for the MFU ratio, overriding the
    # utils/flops.py device-kind registry — for kinds the registry
    # does not know (new hardware, CPU test runs). 0 = registry only;
    # unknown kinds then report achieved TFLOP/s without an MFU ratio.
    peak_tflops: float = 0.0

    # ---- pod tracer (telemetry/trace.py) ----
    # Cross-host span timeline: every subsystem (engine phases,
    # checkpoint snapshot/commit/restore, staging-queue waits, offload
    # requests, deadman verdicts) emits spans into per-thread rings,
    # flushed as runs/<run>/trace/trace.<rank>.jsonl at each epoch
    # boundary and on every fatal ramp; `python -m imagent_tpu
    # .telemetry trace <run_dir>` merges them into one skew-corrected
    # Perfetto-loadable trace.json. "phases" coalesces per-step
    # dispatches into windows; "steps" records every dispatch
    # individually (one span per optimizer step). Off by default: off
    # means NO recorder — zero files, zero ring cost.
    trace: str = "off"
    # Spans kept per thread between flushes (oldest dropped, counted).
    trace_buffer: int = 4096

    # ---- resilience (imagent_tpu/resilience/) ----
    # Non-finite step guard: bad steps are always skipped in-graph
    # (train.py); after this many CONSECUTIVE skipped steps the engine
    # rolls the state back to the last restorable checkpoint and
    # replays (0 disables the rollback policy, not the skip).
    max_bad_steps: int = 3
    # Step-progress watchdog: if no train step completes within this
    # many seconds (hung collective, wedged input pipeline), dump
    # all-thread stacks and checkpoint-and-exit like a preemption
    # (0 = off).
    watchdog_secs: float = 0.0
    # Rotated fallback copies of the LAST checkpoint (last.1..last.K)
    # kept for the integrity-verified restore chain LAST -> previous
    # LASTs -> BEST. 0 = single-slot legacy behavior.
    keep_last_k: int = 1
    # Fault-injection drills: arm named fault points, e.g.
    # "nan-grads:after=4;times=4,stall-step:secs=6"
    # (resilience/faultinject.py; also via IMAGENT_FAULTS env var).
    faults: str = ""
    # Out-of-band partial-pod-failure detection (resilience/heartbeat +
    # deadman): each host writes a heartbeat record to
    # <log_dir>/heartbeats/ and monitors its peers with NO collectives;
    # a peer stale past this deadline (or leaving a fatal tombstone)
    # degrades the pod — emergency snapshot, retryable exit, launcher
    # requeue onto --resume. 0 = off. Must be >= 2x --heartbeat-secs.
    peer_deadline_secs: float = 0.0
    # Heartbeat write cadence for the mesh above.
    heartbeat_secs: float = 2.0
    # Elastic pod (imagent_tpu/elastic.py): when a peer dies the
    # deadman verdict becomes CONTINUE — survivors land the salvage
    # snapshot and re-initialize as a SMALLER mesh over the pod-agreed
    # roster (shrink-to-survive); a relaunch with the replacement host
    # present re-expands (grow-on-requeue), and a waiting host's join
    # request stops the running pod at a pod-agreed step to re-form.
    # Requires --global-batch (the optimization trajectory must not
    # follow the world size) and the plain data-parallel path. Implies
    # resume-if-checkpoint-exists so every rendezvoused attempt agrees
    # on the restore.
    elastic: bool = False
    # Fixed GLOBAL optimization batch, decoupled from world size:
    # per-host batch x grad-accum is recomputed as
    # global_batch / (batch_size x data_parallel_size) on every
    # (re)start, so a resize changes gradient-accumulation depth, not
    # the loss trajectory. 0 = legacy behavior (global batch =
    # batch_size x dp x grad_accum). Must be divisible by
    # batch_size x dp at every world size the pod may shrink/grow to.
    global_batch: int = 0
    # Elastic rendezvous settle window: the roster leader commits the
    # partial join set after this long with no new joiner (a full
    # world commits immediately). Bounds how long a resize waits for
    # a slow host before excluding it (it becomes a grow request).
    elastic_settle_secs: float = 10.0

    # ---- mesh geometry / parallelism strategies ----
    # Data-parallel size is inferred (devices / model_parallel). A model axis
    # is first-class in the mesh design (SURVEY §2c disposition) even though
    # the parity workload only uses the data axis.
    model_parallel: int = 1
    # Mesh-axis shorthand (the production spelling for model-axis pods):
    # --tp N == --tensor-parallel --model-parallel N; --pp N ==
    # --pipeline-parallel N; --dp N asserts the resulting data-parallel
    # degree (refused loudly on mismatch instead of silently resharding).
    # 0 = unset; the engine resolves these into the legacy fields before
    # any validation, and refuses mixed spellings.
    tp: int = 0
    pp: int = 0
    dp: int = 0
    # Sequence parallelism over the model axis (ViT only):
    # none | ring (ring attention) | ulysses (all-to-all head exchange).
    seq_parallel: str = "none"
    # Megatron-style tensor parallelism over the model axis (ViT only):
    # heads + MLP hidden shard across chips (parallel/tensor_parallel.py).
    tensor_parallel: bool = False
    # GPipe pipeline parallelism over the pipe axis: ViT encoder layers
    # split into stages (any S), or the ResNet conv stages (S=2),
    # microbatches streamed via ppermute (parallel/pipeline.py,
    # parallel/resnet_pipeline.py). On ViT composes with
    # --tensor-parallel,
    # --seq-parallel ring|ulysses, and (at --moe-every 1)
    # --expert-parallel — 3-D mesh in every case.
    pipeline_parallel: int = 1
    microbatches: int = 1  # GPipe microbatches per step (pipeline path)
    # Mixture-of-Experts (ViT only): every k-th block's MLP becomes a
    # Switch-routed expert bank (parallel/expert_parallel.py); with
    # --expert-parallel the experts shard over the model axis (GShard
    # all_to_all dispatch).
    moe_every: int = 0
    num_experts: int = 8
    capacity_factor: float = 1.25
    expert_parallel: bool = False
    moe_aux_weight: float = 0.01  # Switch load-balancing loss weight
    moe_top_k: int = 1  # router choices per token (1=Switch, 2=GShard)
    # FSDP (ZeRO-3): params + momentum fully sharded over the data axis
    # via the XLA SPMD partitioner (parallel/fsdp.py) — plain jit with
    # shardings, XLA inserts per-layer all-gathers/reduce-scatters.
    fsdp: bool = False
    # ZeRO-1: shard the SGD momentum buffer over the data axis
    # (parallel/zero.py) — 1/dp optimizer memory per chip, numerically
    # identical updates. Data-parallel path only.
    zero1: bool = False
    # Capacity groups for the dense (non-EP) MoE path. The dispatch
    # tensors are [T/G, E, C] per group with C ~ cf*T/(G*E): more groups
    # = quadratically less dispatch memory. Under --expert-parallel the
    # group count is the expert-axis size and this is ignored.
    moe_groups: int = 8
    # Single-chip attention kernel (ViT only): full (plain einsum) | flash
    # (ops/flash_attention.py: CUDA kernels on the card).
    attn: str = "full"
    # ConvNeXt block lowering (ops/fused_mlp.py): the CUDA-fused
    # LN -> C->4C -> GELU -> 4C->C -> layer-scale -> residual with the
    # 4C intermediate kept on chip (never written to device memory) and
    # an autograd.Function that recomputes it in the backward. "auto"
    # fuses where the kernels' shared memory fits the device and the
    # tensors are on CUDA; "on" fuses wherever the kernels fit (their
    # plain versions on the CPU); "off" (default) is the unfused path.
    fused_mlp: str = "off"
    # ViT perf/regularization levers (models/vit.py): one-GEMM QKV
    # projection (same param tree) and DINOv2-style register tokens
    # (appended, excluded from readout; 59 fills 224px ViT-B/16's 197
    # tokens to the 256-lane MXU tile).
    fused_qkv: bool = False
    register_tokens: int = 0

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Distributed ImageNet training, PyTorch/CUDA port "
                    "(imagent_tpu_torch)"
    )
    c = Config()
    # Reference flag names kept verbatim (imagenet.py:435-450).
    p.add_argument("--seed", type=int, default=c.seed, help="random seed")
    p.add_argument("--backend", type=str, default=c.backend,
                   help="gpu (CUDA, NCCL across ranks; refused when no "
                        "CUDA device) or cpu (gloo across ranks); the "
                        "reference's nccl and gloo mean gpu and cpu")
    p.add_argument("--batch-size", type=int, default=c.batch_size,
                   help="per-replica batch size (default: 128)")
    p.add_argument("--epochs", type=int, default=c.epochs,
                   help="number of epochs to train (default: 100)")
    p.add_argument("--lr", type=float, default=c.lr,
                   help="initial learning rate (default: 0.1)")
    p.add_argument("--save-model", action="store_true", default=False,
                   help="save best checkpoint on val top-1 improvement")
    # Promoted constants.
    p.add_argument("--arch", type=str, default=c.arch,
                   choices=["resnet18", "resnet34", "resnet50",
                            "resnet101", "resnet152", "resnext50_32x4d",
                            "resnext101_32x8d", "wide_resnet50_2",
                            "wide_resnet101_2", "vit_b16", "vit_l16",
                            "vit_h14", "vit_debug", "convnext_tiny",
                            "convnext_small", "convnext_base",
                            "convnext_large"])
    p.add_argument("--image-size", type=int, default=c.image_size)
    p.add_argument("--num-classes", type=int, default=c.num_classes)
    p.add_argument("--data-root", type=str, default=c.data_root)
    p.add_argument("--momentum", type=float, default=c.momentum)
    p.add_argument("--weight-decay", type=float, default=c.weight_decay)
    p.add_argument("--optimizer", type=str, default=c.optimizer,
                   choices=["sgd", "nadam", "adamw", "lars", "lamb"])
    p.add_argument("--lr-decay-period", type=int, default=c.lr_decay_period)
    p.add_argument("--lr-decay-factor", type=float, default=c.lr_decay_factor)
    p.add_argument("--workers", type=int, default=c.workers)
    p.add_argument("--no-native-io", dest="native_io", action="store_false",
                   default=True,
                   help="disable the C++ decode path (PIL fallback)")
    p.add_argument("--decode-offload", type=str, default=c.decode_offload,
                   metavar="HOST:PORT[,HOST:PORT...]",
                   help="decode-offload service endpoints (python -m "
                        "imagent_tpu.data.serve on non-training CPU "
                        "hosts); falls back to local decode when "
                        "unreachable")
    p.add_argument("--input-wait-alert", type=float,
                   default=c.input_wait_alert, metavar="FRACTION",
                   help="WARN + telemetry event + status.json alert "
                        "when an epoch's input-wait exceeds this "
                        "fraction of epoch wall (default 0.10; 0 "
                        "disables)")
    p.add_argument("--log-dir", type=str, default=c.log_dir)
    p.add_argument("--ckpt-dir", type=str, default=c.ckpt_dir)
    # New capabilities.
    p.add_argument("--resume", action="store_true", default=False)
    p.add_argument("--eval-only", action="store_true", default=False,
                   help="validate only (with --resume or "
                        "--init-from-torch), no training")
    p.add_argument("--init-from-torch", type=str, default="",
                   help="torch .pt state_dict to convert and load "
                        "(the reference's checkpoint format)")
    p.add_argument("--export-torch", type=str, default="",
                   help="write the final params as a torchvision-named "
                        "torch .pt state_dict (inverse of "
                        "--init-from-torch)")
    p.add_argument("--augment", action="store_true", default=False,
                   help="RandomResizedCrop+hflip train augmentation "
                        "(reference parity is OFF)")
    p.add_argument("--dataset", type=str, default=c.dataset,
                   choices=["imagefolder", "tar", "synthetic"],
                   help="tar = {train,val}/*.tar shards (webdataset-style "
                        "class-dir members)")
    p.add_argument("--synthetic-size", type=int, default=c.synthetic_size)
    p.add_argument("--no-bf16", dest="bf16", action="store_false",
                   default=True)
    p.add_argument("--transfer-dtype", type=str, default=c.transfer_dtype,
                   choices=["uint8", "bf16", "float32"],
                   help="image wire dtype host->device; all carry raw "
                        "[0,255] values, normalization is in-graph "
                        "(uint8 = 4x leaner than float32)")
    p.add_argument("--input-bf16", dest="transfer_dtype",
                   action="store_const", const="bf16",
                   default=argparse.SUPPRESS,
                   help="deprecated alias for --transfer-dtype bf16")
    p.add_argument("--prefetch-depth", type=int, default=c.prefetch_depth,
                   help="device prefetch staging depth (default 2 = "
                        "double buffering)")
    p.add_argument("--warmup-epochs", type=int, default=c.warmup_epochs)
    p.add_argument("--label-smoothing", type=float,
                   default=c.label_smoothing)
    p.add_argument("--mixup", type=float, default=c.mixup,
                   help="MixUp Beta(a,a) strength, in-graph (0 = off)")
    p.add_argument("--cutmix", type=float, default=c.cutmix,
                   help="CutMix Beta(a,a) strength, in-graph (0 = off)")
    p.add_argument("--ema-decay", type=float, default=c.ema_decay,
                   help="parameter EMA decay; eval uses the averaged "
                        "weights (0 = off)")
    p.add_argument("--color-jitter", type=float, nargs=3,
                   default=list(c.color_jitter),
                   metavar=("BRIGHTNESS", "CONTRAST", "SATURATION"),
                   help="in-graph photometric jitter strengths "
                        "(torchvision semantics; 0 0 0 = off)")
    p.add_argument("--remat", action="store_true", default=False,
                   help="rematerialize blocks on backward (less HBM)")
    p.add_argument("--stem", default=c.stem, choices=["v1", "s2d"],
                   help="ResNet stem: torchvision 7x7/s2 or "
                        "space-to-depth 4x4/s1 (docs/ROOFLINE.md)")
    p.add_argument("--grad-accum", type=int, default=c.grad_accum,
                   help="micro-batches per optimizer step (default 1)")
    p.add_argument("--schedule", type=str, default=c.schedule,
                   choices=["step", "cosine"])
    p.add_argument("--eval-every", type=int, default=c.eval_every)
    p.add_argument("--log-every", type=int, default=c.log_every)
    p.add_argument("--profile", action="store_true", default=False,
                   help="whole-run jax.profiler trace into --log-dir "
                        "(prefer --profile-at-step for long runs)")
    p.add_argument("--profile-at-step", type=str,
                   default=c.profile_at_step, metavar="N[:M]",
                   help="capture a jax.profiler trace for M steps "
                        "(default 10) starting at global step N — "
                        "mid-run and resume-aware, unlike --profile")
    p.add_argument("--no-telemetry", dest="telemetry",
                   action="store_false", default=True,
                   help="disable goodput/step-time/straggler telemetry "
                        "(TB scalars + telemetry.jsonl)")
    p.add_argument("--straggler-factor", type=float,
                   default=c.straggler_factor,
                   help="flag a host whose input-wait or step p95 "
                        "exceeds this multiple of the pod median")
    p.add_argument("--compile-cache", type=str, default=c.compile_cache,
                   help="persistent XLA compilation cache directory "
                        "(also arms the serialized AOT executable "
                        "store under <dir>/aot — see "
                        "python -m imagent_tpu.compilecache)")
    p.add_argument("--no-aot-steps", dest="aot_steps",
                   action="store_false", default=c.aot_steps,
                   help="disable the one-compile AOT startup path "
                        "(step executables jit on first dispatch; "
                        "chipacct pays its own capture compile)")
    p.add_argument("--check-nans", action="store_true", default=False)
    p.add_argument("--async-ckpt", dest="async_ckpt",
                   action="store_true", default=True,
                   help="commit per-epoch LAST checkpoints on a "
                        "background thread (snapshot-then-commit; "
                        "the default)")
    p.add_argument("--no-async-ckpt", dest="async_ckpt",
                   action="store_false",
                   help="fully synchronous checkpoint saves (the "
                        "step loop stalls for serialize+commit+"
                        "manifest)")
    p.add_argument("--ckpt-format", type=str, default=c.ckpt_format,
                   choices=["snapshot", "orbax"],
                   help="checkpoint format family: snapshot = "
                        "collective-free flat/sharded snapshot formats "
                        "(emergency salvage + any-topology resume); "
                        "orbax = legacy collective Orbax for sharded "
                        "states (escape hatch)")
    # Model-health observability.
    p.add_argument("--no-health-stats", dest="health_stats",
                   action="store_false", default=True,
                   help="disable the in-graph grad/param-norm + "
                        "update-ratio metric tail and the divergence "
                        "early-warning detector")
    p.add_argument("--health-grad-spike", type=float,
                   default=c.health_grad_spike,
                   help="anomaly when grad-norm or update-ratio "
                        "exceeds this factor x its trailing EWMA "
                        "baseline (0 disables)")
    p.add_argument("--health-loss-spike", type=float,
                   default=c.health_loss_spike,
                   help="anomaly when the train loss exceeds this "
                        "factor x its EWMA baseline (loose by design: "
                        "3-4x excursions are normal early training; "
                        "0 disables)")
    p.add_argument("--health-warmup-steps", type=int,
                   default=c.health_warmup_steps,
                   help="clean steps the health baselines absorb "
                        "before any anomaly verdict")
    p.add_argument("--health-rollback", action="store_true",
                   default=False,
                   help="roll back to the last good checkpoint on a "
                        "health anomaly (divergence caught BEFORE the "
                        "non-finite guard; default: warn only)")
    p.add_argument("--flightrec-steps", type=int,
                   default=c.flightrec_steps,
                   help="flight-recorder ring size: last N lagged "
                        "step/health records flushed as "
                        "flightrec.<rank>.json on fatal exits "
                        "(0 disables)")
    # SLO engine + OpenMetrics exporter.
    p.add_argument("--slo", type=str, default=c.slo, metavar="SPEC",
                   help="declarative run-health SLOs evaluated at "
                        "every epoch boundary (telemetry/slo.py): "
                        "'off', 'default' (built-in spec), or a JSON "
                        "spec file; breaches become slo_breach "
                        "events, TB markers, status.json fields and "
                        "loud prints")
    p.add_argument("--metrics-port", type=int, default=c.metrics_port,
                   help="serve live OpenMetrics/Prometheus text on "
                        "this port from process 0 (GET /metrics; "
                        "goodput, step percentiles, health, pod, "
                        "ckpt, SLO and compile series; 0 = off)")
    # Chip accountant + OOM preflight.
    p.add_argument("--no-chipacct", dest="chipacct",
                   action="store_false", default=c.chipacct,
                   help="skip the startup XLA cost/memory capture, "
                        "MFU accounting and the OOM preflight "
                        "(telemetry/chipacct.py); also the bypass "
                        "for a preflight refusal")
    p.add_argument("--hbm-budget-gb", type=float,
                   default=c.hbm_budget_gb, metavar="GIB",
                   help="per-device HBM budget for the OOM preflight "
                        "when the backend reports no limit (or to "
                        "tighten it); modeled peak over budget "
                        "refuses the run with exit 78 (0 = device "
                        "limit when known, else no refusal)")
    p.add_argument("--peak-tflops", type=float, default=c.peak_tflops,
                   metavar="TFLOPS",
                   help="peak bf16 TFLOP/s per chip for the MFU "
                        "ratio, overriding the device-kind registry "
                        "(unknown kinds otherwise report achieved "
                        "TFLOP/s only; 0 = registry)")
    # Pod tracer.
    p.add_argument("--trace", type=str, default=c.trace,
                   choices=["off", "phases", "steps"],
                   help="cross-host span timeline (telemetry/trace.py)"
                        ": phases = phase boundaries + coalesced "
                        "dispatch windows, steps = every dispatch "
                        "individually; per-rank trace/trace.<rank>"
                        ".jsonl merged by `python -m imagent_tpu"
                        ".telemetry trace` into Perfetto-loadable "
                        "trace.json (off = no recorder, zero cost)")
    p.add_argument("--trace-buffer", type=int, default=c.trace_buffer,
                   help="spans kept per thread between trace flushes "
                        "(oldest dropped and counted; default 4096)")
    # Resilience subsystem.
    p.add_argument("--max-bad-steps", type=int, default=c.max_bad_steps,
                   help="consecutive non-finite (skipped) steps before "
                        "rolling back to the last good checkpoint "
                        "(0 disables rollback; the in-graph skip is "
                        "always on)")
    p.add_argument("--watchdog-secs", type=float, default=c.watchdog_secs,
                   help="step-progress watchdog deadline: dump stacks "
                        "and checkpoint-and-exit if no step completes "
                        "in this many seconds (0 = off)")
    p.add_argument("--keep-last-k", type=int, default=c.keep_last_k,
                   help="rotated fallback copies of the LAST checkpoint "
                        "for the verified restore chain (0 = one slot)")
    p.add_argument("--faults", type=str, default=c.faults,
                   help="arm fault-injection drill points, e.g. "
                        "'nan-grads:after=4;times=4' (see "
                        "resilience/faultinject.py)")
    p.add_argument("--peer-deadline-secs", type=float,
                   default=c.peer_deadline_secs,
                   help="declare a pod peer dead when its out-of-band "
                        "heartbeat is stale this long: emergency "
                        "snapshot + retryable exit for the launcher "
                        "requeue (0 = off; >= 2x --heartbeat-secs)")
    p.add_argument("--heartbeat-secs", type=float,
                   default=c.heartbeat_secs,
                   help="per-host heartbeat write cadence for the "
                        "peer deadman (default 2s)")
    p.add_argument("--elastic", action="store_true", default=False,
                   help="elastic pod: survivors of a peer death "
                        "re-form a smaller mesh and keep training "
                        "(shrink-to-survive); relaunches re-expand "
                        "(grow-on-requeue). Requires --global-batch; "
                        "DP path only; implies resume-if-checkpoint")
    p.add_argument("--global-batch", type=int, default=c.global_batch,
                   help="fixed global optimization batch, decoupled "
                        "from world size: grad-accum is derived as "
                        "global_batch/(batch_size x dp) so a resize "
                        "keeps the loss trajectory (0 = legacy "
                        "batch_size x dp x grad_accum)")
    p.add_argument("--elastic-settle-secs", type=float,
                   default=c.elastic_settle_secs,
                   help="elastic rendezvous settle window: commit the "
                        "partial roster after this long with no new "
                        "joiner (full world commits immediately)")
    p.add_argument("--model-parallel", type=int, default=c.model_parallel)
    p.add_argument("--tp", type=int, default=c.tp, metavar="N",
                   help="tensor-parallel degree (shorthand for "
                        "--tensor-parallel --model-parallel N); model "
                        "groups of N devices jointly hold one replica")
    p.add_argument("--pp", type=int, default=c.pp, metavar="N",
                   help="pipeline-parallel degree (shorthand for "
                        "--pipeline-parallel N), composable with --tp")
    p.add_argument("--dp", type=int, default=c.dp, metavar="N",
                   help="expected data-parallel degree; validated "
                        "against world size / replica size (0 = infer)")
    p.add_argument("--seq-parallel", type=str, default=c.seq_parallel,
                   choices=["none", "ring", "ulysses"])
    p.add_argument("--tensor-parallel", action="store_true", default=False,
                   help="shard attention heads + MLP over the model axis")
    p.add_argument("--pipeline-parallel", type=int, default=c.pipeline_parallel,
                   help="GPipe stages over the pipe mesh axis (ViT only)")
    p.add_argument("--microbatches", type=int, default=c.microbatches,
                   help="GPipe microbatches per step (pipeline path)")
    p.add_argument("--moe-every", type=int, default=c.moe_every,
                   help="every k-th ViT block uses a MoE MLP (0 = dense)")
    p.add_argument("--num-experts", type=int, default=c.num_experts)
    p.add_argument("--capacity-factor", type=float,
                   default=c.capacity_factor)
    p.add_argument("--expert-parallel", action="store_true", default=False,
                   help="shard MoE experts over the model axis (all_to_all)")
    p.add_argument("--moe-aux-weight", type=float, default=c.moe_aux_weight)
    p.add_argument("--moe-top-k", type=int, default=c.moe_top_k,
                   help="router choices per token (1=Switch, 2=GShard)")
    p.add_argument("--fsdp", action="store_true", default=False,
                   help="fully shard params+optimizer over the data axis "
                        "(XLA SPMD partitioner)")
    p.add_argument("--zero1", action="store_true", default=False,
                   help="shard optimizer state over the data axis (ZeRO-1)")
    p.add_argument("--moe-groups", type=int, default=c.moe_groups,
                   help="capacity groups on the dense MoE path (dispatch "
                        "memory scales as 1/groups^2)")
    p.add_argument("--attn", type=str, default=c.attn,
                   choices=["full", "flash"],
                   help="ViT attention kernel (flash = the hand-written "
                        "CUDA flash kernels)")
    p.add_argument("--fused-mlp", type=str, default=c.fused_mlp,
                   choices=["auto", "on", "off"],
                   help="ConvNeXt: CUDA-fused LN->MLP->residual block, "
                        "4C intermediate kept on chip (auto = fuse where "
                        "the kernels' shared memory fits, on CUDA; off = "
                        "the unfused path)")
    p.add_argument("--fused-qkv", action="store_true",
                   default=c.fused_qkv,
                   help="ViT: one fused QKV GEMM (same param tree)")
    p.add_argument("--register-tokens", type=int,
                   default=c.register_tokens,
                   help="ViT: learned register tokens appended to the "
                        "sequence, excluded from readout (59 fills "
                        "224px ViT-B/16 to the 256-token MXU tile)")
    return p


def parse_args(argv: Sequence[str] | None = None) -> Config:
    ns = build_parser().parse_args(argv)
    fields = {f.name for f in dataclasses.fields(Config)}
    kw = {k: v for k, v in vars(ns).items() if k in fields}
    return Config(**kw)


# ---------------------------------------------------------------------------
# The slice of the flag surface this port implements.
# ---------------------------------------------------------------------------

# Fields the port honours. Any other field must keep its default: a
# non-default value is refused at start-up (``check_ported``), never
# silently ignored.
PORTED = frozenset({
    "seed", "backend", "batch_size", "epochs", "lr", "save_model", "arch",
    "image_size", "num_classes", "mean", "std", "momentum", "weight_decay",
    "optimizer", "lr_decay_period", "lr_decay_factor", "workers", "log_dir",
    "ckpt_dir", "resume", "dataset", "synthetic_size", "bf16",
    "prefetch_depth", "warmup_epochs", "label_smoothing", "grad_accum",
    "schedule", "eval_every", "log_every", "health_stats", "max_bad_steps",
    "attn", "fused_qkv", "register_tokens", "fused_mlp", "stem", "dp",
    "global_batch", "data_root", "augment", "transfer_dtype", "native_io",
})
# Values of the ported fields that this slice supports.
PORTED_ARCHS = ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
                "resnext50_32x4d", "resnext101_32x8d", "wide_resnet50_2",
                "wide_resnet101_2", "vit_b16", "vit_l16", "vit_h14",
                "vit_debug", "convnext_tiny", "convnext_small",
                "convnext_base", "convnext_large")
PORTED_OPTIMIZERS = ("sgd", "adamw")
PORTED_DATASETS = ("synthetic", "imagefolder", "tar")
BACKENDS = ("gpu", "cpu")
# The reference's operator values (``--backend=nccl``, imagenet.sh:26),
# as the JAX package's ``cluster.initialize`` maps them.
BACKEND_ALIASES = {"nccl": "gpu", "gloo": "cpu"}


def _norm(value):
    return tuple(value) if isinstance(value, (list, tuple)) else value


def unported_fields(cfg: Config) -> dict:
    """``{field: value}`` for every field outside ``PORTED`` whose value
    differs from its default."""
    default = Config()
    return {f.name: getattr(cfg, f.name)
            for f in dataclasses.fields(Config)
            if f.name not in PORTED
            and _norm(getattr(cfg, f.name)) != _norm(getattr(default, f.name))}


def default_on_unported() -> tuple:
    """Fields outside ``PORTED`` that are True by default: subsystems
    the JAX package runs unless told not to and this port does not run
    (``unported_fields`` refuses only values that differ from the
    default, so a default run would skip them without a word)."""
    default = Config()
    return tuple(f.name for f in dataclasses.fields(Config)
                 if f.name not in PORTED and getattr(default, f.name) is True)


def skipped_line() -> str:
    """The start-up line that names ``default_on_unported()``."""
    return ("not run by this port (on by default in the JAX package): "
            + ", ".join(default_on_unported()))


def check_ported(cfg: Config) -> None:
    """Raise ``ValueError`` naming what this slice does not port yet."""
    bad = unported_fields(cfg)
    if bad:
        raise ValueError(
            "not yet ported to imagent_tpu_torch: "
            + ", ".join(f"{k}={v!r}" for k, v in sorted(bad.items())))
    for field, value, allowed in (
            ("arch", cfg.arch, PORTED_ARCHS),
            ("optimizer", cfg.optimizer, PORTED_OPTIMIZERS),
            ("dataset", cfg.dataset, PORTED_DATASETS)):
        if value not in allowed:
            raise ValueError(
                f"--{field} {value} is not yet ported to imagent_tpu_torch "
                f"(this slice supports {', '.join(allowed)})")
    if cfg.backend not in BACKENDS + tuple(BACKEND_ALIASES):
        raise ValueError(
            f"--backend must be one of "
            f"{'|'.join(BACKENDS + tuple(BACKEND_ALIASES))}, "
            f"got {cfg.backend!r}")
