#!/usr/bin/env python3
"""Smoke test and measurement of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout, one card
    python3 chip_smoke.py lm   # phases alone: 2d 3d sharded campaign
                               # serve tune systems lm train families mesh
                               # dryrun

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
(one ``nvcc`` per source and per tap-set library of the 2-D template
``stencil2d.cu``, for the four 2-D Table-2 stencils and the 169- and
289-tap sets ``box(2, radius=6)`` and ``blur(2, radius=8)``, and of the
3-D template ``stencil3d.cu``, for the five 3-D ones, the lifted j2d5pt
and the 343-tap ``box(3, radius=3)``, all started together; each
library's seconds and ptxas's registers and spill stores, and for the
two templates their stack frames, are printed per kernel instantiation,
a 2-D or large-set instantiation with a spill store or a stack frame
fails the run, and the 3-D phase prints each launch's
``kernel_smem_bytes`` against the planner's ``smem_bytes_3d`` budget),
then drives the port's paths through the entry points a user calls, each
in its own counted run:

* 2-D (``stencil2d``): ``compile_stencil(...).apply`` and ``.run`` for the
  four 2-D Table-2 stencils at their Table-2 domains (8352², 8064², 8784²,
  8640²), f32, at the EBISU depth of Table 3 (t = 12, 8, 6, 4), plus one
  periodic and one f64 program of j2d5pt; ``run_batched`` of four j2d5pt
  fields at 8352² (one launch a sweep for the batch), ``run_padded`` of
  j2d5pt, and ``.run`` of the 169- and 289-tap sets at 4096²;
* 3-D (``stencil3d``): the five 3-D Table-2 stencils at the paper's
  2560×288×384, f32, at t = 8, 5, 6, 5, 6, plus one periodic and one f64
  program of j3d7pt, one ``mode="stream"`` apply of j2d5pt at 8352²
  (the 2-D field streamed through the 3-D kernel as 8352×1×8352),
  ``run_batched`` of two j3d7pt fields at 2560×288×384 and ``.run`` of
  the 343-tap set at 512×288×384;
* sharded (no kernel): ``compile_stencil(..., mesh=)`` and
  ``run_sharded`` on a (2, 2) mesh of ``cuda:0`` × 4 (the shards share
  the card; slabs move by on-device copies): j2d5pt at 8352², t = 12,
  25 steps, under Dirichlet(0), periodic and reflect, and j3d7pt at
  2560×288×384, t = 8, 17 steps, sharded over z and y, f32.  The shards
  compute in plain torch, as the reference's compute in plain jnp, so
  no stencil kernel launches; the exchange count must be
  ``planned_exchange_rounds(T, t) × 2 × 2``.  A mesh of size 1 runs
  ``.run`` and must launch its 3 sweeps;
* campaign (``stencil2d``, ``stencil3d``): ``run_resumable`` of j2d5pt
  at 8352² (t = 12, 25 steps: fresh with ``every`` 1 and 2, crashed
  after leg 2 and resumed, a poisoned leg rolled back) and of j3d7pt at
  2560×288×384 (t = 8, 17 steps: fresh, crashed and resumed), f32,
  checkpoints in a temporary directory removed afterwards; the launches
  must equal the sweeps of the legs run, exactly;
* serve (``stencil2d``, ``stencil3d``): the stencil service
  (``repro_torch.serve.stencil_service``): 8 j2d5pt requests at 8352²
  (t = 12, 25 steps) from four tenants coalesced by ``ServiceCore`` into
  one ``run_batched``, which must launch 3 sweeps for all of them (a
  loop of ``.run`` launches 24), the same at 512², then 2 j3d7pt
  requests at 2560×288×384 (t = 8, 17 steps: 3 launches against 6),
  f32, each result within 1e-4 of its field's ``.run``, with p50/p99
  latency, requests/s and the coalesced ms beside the loop's and its
  parts timed alone; the seeded faulty tape of
  ``launch/serve_stencil.py`` (200 requests, seed 7) and 32 requests
  through the asyncio front door, every request resolved;
* tune (``stencil2d``, ``stencil3d``): ``repro_torch.tuning.tune`` of
  j2d5pt at 8352² and j3d7pt at 2560×288×384, budget 64 timing calls
  (CUDA events) into a plan DB in a temporary directory, the winner's
  ``.run`` timed beside the analytic seed's and held to the oracle
  (< 1e-4), its launches counted; then ``python -m repro_torch.tuning
  check`` in a second process must hit both records with zero timing
  calls;
* systems (no kernel): the three coupled systems of
  ``repro_torch.systems`` at 512², periodic and Neumann, on the card
  against the same programs on the CPU in float64, then timed at 4096²
  in f32 (plain torch);
* LM serving (``flash_attention``): ``launch.serve.run`` serves
  h2o-danube-1.8b at its published widths (24 layers, d_model 2560, 32
  heads, 8 kv heads, hd 80, window 4096; weights random from a seed, bf16)
  to a batch of 4 prompts of 8192 tokens and decodes 32 greedy tokens,
  with ``attention_impl="flash_pallas"``, so every prefill layer launches
  the CUDA flash forward kernel (24 per prefill; one warm-up and two timed
  prefills; bf16: the tensor-core kernel of ``csrc/flash_attention_mma.cu``,
  while float32 inputs run the 3xTF32 tensor-core kernel of
  ``csrc/flash_attention_tf32.cu``, counted in the f32 whole path, 4
  launches: 2 layers, a prefill and greedy decoding's);
* training (``flash_attention_bwd``): ``launch.train.train`` trains
  h2o-danube-1.8b at the same widths (bf16 parameters and activations,
  remat, its own 2 microbatches) for 3 AdamW steps at batch 2 × 8192
  tokens (so the 4096 window binds) with no checkpoint directory:
  every layer launches the flash forward kernel twice per microbatch
  (forward and remat recompute) and each backward kernel once (bf16: the
  tensor-core kernels of ``csrc/flash_attention_mma.cu`` and
  ``csrc/flash_attention_bwd_mma.cu``; float32 inputs run the 3xTF32
  kernels of ``csrc/flash_attention_tf32.cu`` and
  ``csrc/flash_attention_bwd_tf32.cu``, counted in the f32 whole training
  path: a loss and its gradients, then a step of 2 microbatches at depth
  2, 12 forward launches and 6 of each backward kernel).

* families (``flash_attention``, ``flash_attention_bwd``): the other LM
  families at their published widths, bf16, ``flash_pallas``, random
  weights from a seed: ``launch.serve.run`` serves mamba2-130m (no
  attention: 0 launches a prefill), zamba2-2.7b (9: one per shared-block
  invocation), granite-moe-3b-a800m (32), internvl2-1b (24; 7936 tokens
  after its 256 patches) to 4 prompts of 8192 positions with 32 greedy
  tokens, and qwen3-moe-235b-a22b with its depth cut to 2 of 94 layers
  (2 launches; its experts do not fit one card whole) to 1 prompt of
  4096 with 8; ``transformer.prefill``'s encoder branch runs
  hubert-xlarge's 48 layers over 4 × 4096 frames (48 launches, every
  one bidirectional); each run's prefill and a decode step are then
  profiled (``torch.profiler``: the device's busy share and the longest
  kernels); and one AdamW step of mamba2, zamba2, granite, hubert and
  internvl2 at depth 2 in f32 (1 × 1024 positions, one microbatch,
  remat) launches the forward kernel twice and each backward kernel
  once per attention call.
* mesh (``flash_attention``, ``flash_attention_bwd``): LM-side
  parallelism on a (2, 2) ``(data, model)`` mesh of ``cuda:0`` × 4
  (``models/parallel.py``; collectives are on-card copies):
  ``launch.serve.run(n_data=2, n_model=2)`` serves h2o-danube-1.8b at
  its published widths (4 × 8192, 32 tokens; 96 flash launches a
  prefill, one per layer per shard, at 2 rows and 16 of 32 heads) and
  mamba2-130m (12 of 24 SSM heads a shard); ``launch.train.train``
  takes two steps of h2o-danube-1.8b at 4 × 8192 (2 microbatches, each
  1 + 1 rows over ``data``; ZeRO moments); ``transformer.prefill`` of
  granite-moe-3b-a800m runs expert-parallel (24 of 48 padded experts a
  model shard, gathered over ``data``).  Every flash launch and every
  collective (``psum``, ``pmean``, ``all_gather``, by axis) is held to
  its prediction.
* dryrun (``stencil2d``, ``stencil3d``, ``flash_attention``,
  ``flash_attention_bwd``): the deprecated shims with ``plan=None``
  (``ops.ebisu_stencil`` of j2d5pt at 8352², t = 12: one launch at the
  request-default tile; ``sweep.run_sweeps`` of j3d7pt at
  2560×288×384, 17 steps: three), each warning and held to the planned
  program (< 1e-4), the request-default tiles' kernel ms beside the
  planned tiles'; h2o-danube-1.8b served at 4 × 8192 with
  ``attention_impl="boundary_stub"`` (no flash launch) and mamba2-130m
  prefilled with ``ssm_impl="boundary_stub"``, each beside its kernel's
  or scan's prefill; h2o-danube with ``sharding="fsdp"`` on the (2, 2)
  ``cuda:0`` × 4 mesh, in f32 at depth 2 against the unsharded path
  (the mesh phase's limits) and in bf16 at full width (prefill and
  train-step ms; flash launches, one a layer a shard, and collectives
  held to a run of the same program on meta shards); the dry run's
  record of h2o-danube's prefill on the mesh phase's (2, 2) layout at
  4 × 8192 against the card's run of it (``argument_bytes`` and
  ``dot_flops`` exact, the collectives the mesh phase's, the peak
  beside ``max_memory_allocated``), and the ``stencil-suite`` j2d5pt
  record's ``collective-permute`` count against ``run_sharded``'s
  exchanges on the card.

Every kernel's launch count is zeroed just before each run and read just
after it, and must show every launch the run calls for and none of the
other kernels.

Then, outside the counted runs: the stencil results against the port's
plain oracle on the card (max |err| < 1e-4 in f32, < 1e-10 in f64), each
stencil kernel against its plain version on the main path's own padded
inputs and against a second launch, bit for bit (the large tap sets
too); ``run_batched`` against a loop of ``.run`` and ``run_padded``
against ``.run``, bit for bit, with the batched and looped times side
by side; each sharded run against ``.run`` on the card (< 1e-4) and
against a second call, bit for bit, timed beside ``.run``, and the
refusal of ``make_stencil_mesh((2, 2))`` without ``devices=`` on a host
of fewer than four cards; each campaign against ``.run``, bit for bit,
a sharded campaign that loses a device restored onto (2, 1) (< 1e-4 of
``.run``), the CLI killed after leg 2's checkpoint (exit 137) in a
subprocess and resumed, its ``--out`` equal to a straight run's, and
the campaign's time with its checkpoints beside ``.run``'s; the
whole LM path in f32 at full width and depth 2, kernel against the chunked
attention path (last-token logits < 1e-4, greedy agreement printed), and
so each family's at 1 × 4096 positions; the
whole training path in f32 at full width and depth 2, kernels against the
chunked path (loss < 1e-4, each gradient leaf within 1e-4 of its largest
|value|, parameters after one AdamW step < 2e-4), and so each family's
step; on the (2, 2) mesh in f32 at depth 2, h2o-danube's prefill,
decode step and train step and mamba2's prefill and decode step against
the unsharded ones on the card (the same limits; besides, the AdamW
step's update within 0.25·lr of the unsharded one, and every ZeRO slice
of each leaf the unsharded step moves densely moved by a median above
lr/2), and ``apply_moe_ep``
at granite's widths against each data shard's dense dispatch at the
same capacity (< 1e-4, with drops; the aux loss the shards' mean, within
5 % of the global one); the flash forward and
backward kernels against their plain versions at the full-width layer shapes
(f32 out < 2e-5 and lse < 1e-4; bf16 out within 1e-4 + 2^-6·|want| per
element, two units in the last place, with a control that the limit
refuses one key dropped from each window, bf16 lse < 1e-4 and a second
launch equal bit for bit; both instantiations; the
backward's gradients: f32 < 1e-4 (the float32 kernels of
``csrc/flash_attention_bwd_tf32.cu``), bf16 within the same per-element limit,
with the window − 1 control and a second launch equal bit for bit) and at
small ones (GQA 1/2/4/8, bidirectional, hd 16/64/80/96/128/144/256,
windows on the tile edges, S no multiple of 64, rows that keep no
key), and the forward at each family's served layer shape, both
instantiations (hubert's 4 × 4096 16/16 hd 80 bidirectional; zamba2's
32/32 hd 80, granite's 24/8 hd 64 and internvl2's 14/2 hd 64 at 4 ×
8192; qwen3-moe's 1 × 4096 64/4 hd 128; the bf16 control drops one key
from every row: the diagonal key of a causal row, the last key
otherwise), and at each per-shard shape of the mesh phase (h2o-danube's
16/4 hd 80 at 2 × 8192 and 1 × 8192, window 4096; granite's 12/4 hd 64
at 2 × 8192); and the backward kernels at the mesh train step's
per-shard shape (h2o-danube's 1 × 8192 16/4 hd 80, window 4096; f32
< 1e-4, bf16 within two ulps, with the window − 1 control).  Timings
use CUDA events (warm-up, then the median): each
kernel's ms, its plain version's,
and a one-call yardstick the port never calls, ``library_ms``: ``t``
chained ``conv2d``/``conv3d`` calls (TF32 off) for the stencils, one
``scaled_dot_product_attention`` with the same boolean mask and
``enable_gqa=True`` for attention (its backward alone, by
``torch.autograd.grad``, for the backward kernel, with the backend that
ran it printed).  The float32 kernels are timed too, at the same layer
shapes in float32 (the forward with and without the lse, dQ and dK/dV
apart), each beside its plain version, its bound at the dense TF32
tensor peak and ``scaled_dot_product_attention`` (and its backward) in
float32 with ``torch.backends.cuda.matmul.allow_tf32 = False``, with the
backend it took; they are the ``flash_attention_f32`` and
``flash_attention_bwd_f32`` entries of the ``kernels`` line.  The
``[model]`` lines give what is counted, not measured, of the forward and
backward kernels of both dtypes: their tiles, the
flops they issue per kept pair, their shared memory and ptxas's
registers and spill stores, and the forward's modelled flops over its
measured ms; for each 2-D sweep, its CTAs (interior ones apart), the
rows a thread computes, the trapezoid's cell-updates and those computed,
each step's lane use, the shared reads per cell-update, and the
cell-updates over its measured ms; for each 3-D sweep, the cell-updates
its trapezoid schedule computes over its measured ms.  The bound of a
stencil sweep is the larger of its bytes (the domain read once, the
padded layout written once) over 3.35 TB/s and
``flops_per_cell·t·cells`` over 67 TFLOP/s fp32 (34 fp64); of an
attention call, the larger of q, k, v read and o written
once over 3.35 TB/s and ``4·hd`` flops per (query, key) pair the mask
keeps over 989 TFLOP/s dense bf16, 495 dense TF32 for float32 (H100
SXM datasheet peaks); of a backward call, q, k, v, o, do and lse read
and dq, dk, dv written once, and ``10·hd`` flops per kept pair.  The 2-D
rows also give ``bound_copy_ms`` (the measured device-to-device copy rate
in place of 3.35 TB/s) and ``ms_f32_at_f64_tile`` (the f32 sweep at the
f64 plan's smaller tile, which tells the tile's cost from the type's).

The last lines are the card's ``name, power.limit``, one JSON object of
the kernels, and ``{"ok": true, "device": {...}}``.  Any failed phase
raises, and the script exits non-zero without printing that last line;
so it does without a CUDA device or outside a checkout.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPLACES = "src/repro/kernels/stencil2d.py:54"
SOURCE = "src/repro_torch/kernels/csrc/stencil2d.cu"
REPLACES_3D = "src/repro/kernels/stencil3d.py:134"
SOURCE_3D = "src/repro_torch/kernels/csrc/stencil3d.cu"
REPLACES_FA = ("src/repro/kernels/flash_attention.py:35 and "
               "src/repro/kernels/flash_attention.py:127")
SOURCE_FA = "src/repro_torch/kernels/csrc/flash_attention_mma.cu"
SOURCE_FA_F32 = "src/repro_torch/kernels/csrc/flash_attention_tf32.cu"
REPLACES_FA_BWD = "src/repro/kernels/flash_attention.py:140"
SOURCE_FA_BWD = "src/repro_torch/kernels/csrc/flash_attention_bwd_mma.cu"
SOURCE_FA_BWD_F32 = (
    "src/repro_torch/kernels/csrc/flash_attention_bwd_tf32.cu")
# the LM phase: h2o-danube-1.8b at its published widths, served
LM_ARCH = "h2o-danube-1.8b"
LM_BATCH, LM_PROMPT, LM_NEW, LM_REPEATS = 4, 8192, 32, 2
LM_WHOLE_PATH_TOL = 1e-4     # f32 last-token logits, kernel vs chunked
# the train phase: h2o-danube-1.8b at its published widths, trained
TRAIN_ARCH = "h2o-danube-1.8b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 3, 2, 8192
TRAIN_LOSS_TOL = 1e-4        # f32 whole path, kernels vs chunked
TRAIN_GRAD_TOL = 1e-4        # × the leaf's largest |value|
TRAIN_PARAM_TOL = 2e-4       # the reference's microbatch test tolerance
# AdamW's first step moves each parameter by about lr·sign(g), so a
# gradient element within noise of 0 can flip its step between the two
# paths: at lr 1e-4 such a flip stays under TRAIN_PARAM_TOL
TRAIN_CHECK_LR = 1e-4
# bf16 out, kernel vs plain: |err| <= atol + rtol·|want| per element.  Both
# round one float32 result to bf16, so a sound kernel is at most one unit
# in the last place (2^-7·|want|) away; the limit allows two.
BF16_ATOL, BF16_RTOL = 1e-4, 2.0 ** -6
# the families phase: served at the published widths in bf16 (arch, batch,
# prompt tokens, new tokens, depth cut); qwen3-moe-235b-a22b's 94 layers
# of 128 experts do not fit one card, so it runs 2 of them.  internvl2's
# 7936 tokens follow its 256 patches: 8192 positions, which the kernel's
# 1024-key chunks divide
FAMILY_SERVE = [("mamba2-130m", 4, 8192, 32, None),
                ("zamba2-2.7b", 4, 8192, 32, None),
                ("granite-moe-3b-a800m", 4, 8192, 32, None),
                ("internvl2-1b", 4, 8192 - 256, 32, None),
                ("qwen3-moe-235b-a22b", 1, 4096, 8, 2)]
FAMILY_REPEATS = 2
ENCODER_ARCH, ENCODER_BATCH, ENCODER_FRAMES = "hubert-xlarge", 4, 4096
# whole paths in f32 at depth 2, each family at 1 × 4096 positions
FAMILY_WHOLE_PATH = ["mamba2-130m", "zamba2-2.7b", "granite-moe-3b-a800m",
                     "qwen3-moe-235b-a22b", "hubert-xlarge", "internvl2-1b"]
FAMILY_WHOLE_PATH_SEQ = 4096
# the flash forward at each new full-width layer shape, at the batch and
# positions its serving run gives it (arch, causal, batch, positions)
FAMILY_LAYER_SHAPES = [("hubert-xlarge", False, ENCODER_BATCH,
                        ENCODER_FRAMES),
                       ("zamba2-2.7b", True, 4, 8192),
                       ("granite-moe-3b-a800m", True, 4, 8192),
                       ("internvl2-1b", True, 4, 8192),
                       ("qwen3-moe-235b-a22b", True, 1, 4096)]
# one AdamW step at depth 2 in f32, batch 1 × 1024 positions, one
# microbatch; the five families (qwen3-moe-235b-a22b's two layers with
# their f32 gradients and moments do not fit one card)
FAMILY_TRAIN = ["mamba2-130m", "zamba2-2.7b", "granite-moe-3b-a800m",
                "hubert-xlarge", "internvl2-1b"]
FAMILY_TRAIN_SEQ = 1024


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED {what}")


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def median_ms(fn, reps: int, warmup: int) -> float:
    """Median over ``reps`` of one call of ``fn``, timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.roofline import hardware_for
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    smi = smi_line()
    print(f"[card] {smi}", flush=True)
    hw = hardware_for(dev)
    print(f"[card] {hw.sm_count} SMs, {int(hw.onchip_bytes)} B shared memory "
          f"per block, {int(hw.l2_bytes)} B L2 (the planner's model "
          f"{hw.name})", flush=True)
    print(f"[versions] python {sys.version.split()[0]} torch "
          f"{torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}", flush=True)

    # ---- build ----------------------------------------------------------
    # one nvcc per source and per tap-set library of the 2-D kernel (the
    # four 2-D Table-2 stencils) and of the 3-D kernel (the five 3-D
    # Table-2 stencils and the lifted j2d5pt), all started together
    from repro_torch.core.stencil_spec import TABLE3_DEPTHS, get, lift_2d_to_3d
    from repro_torch.kernels import stencil2d as st
    from repro_torch.kernels import stencil3d as st3

    tapsets2d = {name: get(name) for name in TABLE3_DEPTHS
                 if get(name).ndim == 2}
    tapsets = {name: get(name) for name in TABLE3_DEPTHS
               if get(name).ndim == 3}
    tapsets["j2d5pt (lifted)"] = lift_2d_to_3d(get("j2d5pt"))
    for name, spec in large_tap_sets().items():
        (tapsets2d if spec.ndim == 2 else tapsets)[name] = spec
    templated = ([("stencil2d", name, st.tapset_header(spec))
                  for name, spec in tapsets2d.items()]
                 + [("stencil3d", name, st3.tapset_header(spec))
                    for name, spec in tapsets.items()])
    jobs = [(name, None) for name in _build.SOURCES] + [
        (lib, header) for lib, _, header in templated]
    seconds = {}

    def timed_build(job):
        t1 = time.perf_counter()
        _build.build(*job)
        seconds[job] = time.perf_counter() - t1

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(timed_build, jobs))
    print(f"[build] {time.perf_counter() - t0:.2f}s for {len(jobs)} "
          f"libraries ({len(tapsets2d)} stencil2d and {len(tapsets)} "
          "stencil3d tap sets)", flush=True)
    for name in _build.SOURCES:
        print(f"[build] {name} {seconds[(name, None)]:.2f}s kernels: "
              "[registers, spill-store bytes] "
              f"{json.dumps(_build.ptxas_usage(_build.build_log(name)))}",
              flush=True)
    for lib, name, header in templated:
        job = (lib, header)
        frames = _build.ptxas_frames(_build.build_log(*job))
        print(f"[build] {lib} {name}: {seconds[job]:.2f}s, "
              f"{_build.library_path(*job).name}; kernels: [registers, "
              "spill-store bytes, stack-frame bytes] "
              f"{json.dumps(frames)}", flush=True)
        if lib == "stencil2d" or name in large_tap_sets():
            check(len(frames) == 2 and all(
                spill == 0 and stack == 0 for _, spill, stack in
                frames.values()), f"{lib} {name}: spill stores or a "
                "stack frame")

    every = ["2d", "3d", "sharded", "campaign", "serve", "tune", "systems",
             "lm", "train", "families", "mesh", "dryrun"]
    phases = sys.argv[1:] or every
    check(set(phases) <= set(every), f"unknown phases {phases}; pass any "
          f"of {' '.join(every)}, or none for all")
    entries = []
    run = {"2d": lambda: two_d(dev), "3d": lambda: three_d(dev, held),
           "sharded": lambda: sharded(dev), "campaign": lambda: campaign(dev),
           "serve": lambda: serve(dev), "tune": lambda: tune(dev),
           "systems": lambda: systems(dev),
           "lm": lambda: lm_serve(dev, held), "train": lambda: lm_train(dev),
           "families": lambda: families(dev, entries),
           "mesh": lambda: mesh(dev, entries),
           "dryrun": lambda: dryrun(dev, entries)}
    for phase in every:
        if phase not in phases:
            continue
        t0 = time.perf_counter()
        entry = run[phase]()
        if entry is not None:      # the phases that own kernels' entries
            entries.extend(entry if isinstance(entry, list) else [entry])
        torch.cuda.empty_cache()
        print(f"[phase] {phase}: {time.perf_counter() - t0:.1f}s",
              flush=True)
    print(f"[card] {smi_line()}", flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def large_tap_sets() -> dict:
    """The tap sets past the 128 taps of earlier libraries, as a user
    builds them: 169 and 289 taps in 2-D, 343 in 3-D."""
    from repro_torch.api.define import blur, box

    return {"box2d-r6": box(2, radius=6), "blur2d-r8": blur(2, radius=8),
            "box3d-r3": box(3, radius=3)}


# the batched runs of the main paths: (stencil, batch); the large sets'
# domains (the paper's 2-D domain is 8352², its 3-D one 2560x288x384)
BATCH_2D, BATCH_3D = ("j2d5pt", 4), ("j3d7pt", 2)
LARGE_DOMAIN_2D, LARGE_DOMAIN_3D = (4096, 4096), (512, 288, 384)


def zero_counts() -> None:
    """Every kernel's launch count, and the exchange count, to 0."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import stencil2d as st
    from repro_torch.kernels import stencil3d as st3

    from repro_torch.core.distributed import ppermute

    for fn in (st.ebisu2d_padded, st3.ebisu3d_padded, fa.flash_attention_fwd,
               fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkdv):
        fn.launches = 0
    ppermute.calls = 0


def stencil_bound(spec, t, cells, padded_cells, itemsize):
    """The least time of one sweep: its bytes (the domain read, the padded
    layout written) over 3.35 TB/s, or its flops over the fp32 (fp64)
    peak; returns (ms, "bytes" or "operations")."""
    from repro_torch.core.roofline import H100

    t_bytes = (cells + padded_cells) * itemsize / H100.b_gm
    t_ops = spec.flops_per_cell * t * cells / (
        H100.thr_cmp_fp64 if itemsize == 8 else H100.thr_cmp)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def conv_yardstick(spec, t, x):
    """``t`` chained ``conv2d``/``conv3d`` calls of the tap set on ``x``
    (TF32 off by the caller): the one-call PyTorch yardstick."""
    import torch
    import torch.nn.functional as F

    rad = spec.radius
    w = torch.zeros((1, 1) + (2 * rad + 1,) * spec.ndim, device=x.device)
    for off, coef in spec.taps:
        w[(0, 0) + tuple(o + rad for o in off)] = coef
    conv = F.conv2d if spec.ndim == 2 else F.conv3d

    def run(v=x[None, None]):
        for _ in range(t):
            v = conv(v, w, padding=rad)
        return v

    return run


def batched_vs_looped(prog, xs, steps, what) -> dict:
    """The batched run against a loop of ``.run`` over the same fields:
    bit for bit, and their times side by side (CUDA events, median)."""
    import torch

    ys = prog.run_batched(xs, steps)
    loop = torch.stack([prog.run(x, steps) for x in xs])
    check(torch.equal(ys, loop), f"{what}: run_batched differs from a loop "
          "of run")
    print(f"[check] {what}: run_batched equal to a loop of run, bit for "
          "bit", flush=True)
    del ys, loop
    batched_ms = median_ms(lambda: prog.run_batched(xs, steps), 5, 1)
    looped_ms = median_ms(lambda: [prog.run(x, steps) for x in xs], 5, 1)
    row = dict(stencil=prog.spec.name, batch=len(xs), steps=steps,
               domain=list(prog.shape), batched_ms=batched_ms,
               looped_ms=looped_ms, looped_over_batched=looped_ms
               / batched_ms)
    print("[timing] " + json.dumps(row), flush=True)
    return row


def large_set_rows(dev, cases, wrapper, plain, held) -> tuple[list, float]:
    """Each large set's program (counted earlier) held to the oracle, its
    kernel to the plain version (two launches, bit for bit) at the
    program's own padded input, and its sweep timed beside the plain
    version, the conv yardstick and the bound."""
    import torch

    from repro_torch.kernels import ref

    rows, max_err = [], 0.0
    for name, c in cases.items():
        prog, x, spec, t = c["prog"], c["x"], c["prog"].spec, c["prog"].t
        held(c["y"], ref.reference(x, spec, c["steps"]), 1e-4,
             f"{name} ({len(spec.taps)} taps) run({c['steps']}) vs oracle")
        g = prog.geometry()
        xp = torch.zeros(g["padded"], device=dev)
        xp[tuple(slice(0, n) for n in x.shape)] = x
        kw = (dict(height=x.shape[0], width=x.shape[1], bh=g["block"][0],
                   bw=g["block"][1]) if spec.ndim == 2 else
              dict(zdim=x.shape[0], ydim=x.shape[1], xdim=x.shape[2],
                   zc=g["block"][0], ty=g["block"][1], tx=g["block"][2]))
        plain_kw = {k: kw[k] for k in ("height", "width", "zdim", "ydim",
                                       "xdim") if k in kw}
        got = wrapper(xp, spec, t, **kw)
        again = wrapper(xp, spec, t, **kw)
        check(torch.equal(got, again), f"{name}: a second launch differs")
        err = held(got, plain(xp, spec, t, **plain_kw), 1e-4,
                   f"{name} kernel vs plain sweep (repeat bit-identical)")
        max_err = max(max_err, err)
        del got, again
        out = torch.empty_like(xp)
        ms = median_ms(lambda: wrapper(xp, spec, t, out=out, **kw), 10, 2)
        plain_ms = median_ms(lambda: plain(xp, spec, t, **plain_kw), 3, 1)
        library = conv_yardstick(spec, t, x)
        held(library()[0, 0], prog.apply(x), 1e-4, f"{name} conv yardstick")
        lib_ms = median_ms(library, 3, 1)
        bound_ms, bound_by = stencil_bound(spec, t, x.numel(), xp.numel(), 4)
        row = dict(stencil=name, taps=len(spec.taps), radius=spec.radius,
                   t=t, domain=list(x.shape), tile=list(g["block"]),
                   padded=list(g["padded"]), ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                   roofline_share=bound_ms / ms, launches=c["launches"])
        rows.append(row)
        print("[timing] " + json.dumps(row), flush=True)
        del xp, out
    return rows, max_err


def held(got, want, tol, what):
    """Check ``got`` against ``want`` within ``tol``; returns max |err|."""
    import torch

    err = float((got.double() - want.double()).abs().max())
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    check(err < tol, f"{what}: max|err| {err:.3e} >= {tol:g}")
    print(f"[check] {what}: max|err| {err:.3e} (< {tol:g})", flush=True)
    return err


def held_bf16(got, want, what):
    """Check bf16 ``got`` against ``want`` element by element within
    ``BF16_ATOL + BF16_RTOL·|want|``; returns (max |err|, the largest
    share of its element's limit)."""
    import torch

    d = (got.double() - want.double()).abs()
    share = float((d / (BF16_ATOL + BF16_RTOL * want.double().abs())).max())
    err = float(d.max())
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    check(share <= 1.0, f"{what}: max|err| {err:.3e}, {share:.3f} of the "
          f"limit {BF16_ATOL:g} + {BF16_RTOL:g}|want|")
    print(f"[check] {what}: max|err| {err:.3e}, at most {share:.4f} of the "
          f"limit {BF16_ATOL:g} + {BF16_RTOL:g}|want|", flush=True)
    return err, share


def bwd_vs_plain(args, causal, win, dtype, what):
    """The flash backward kernels against their plain version on ``args``
    = (q, k, v, do, out, lse): f32 within 1e-4, bf16 within the
    two-ulp per-element limit; returns (max |err|, largest share of the
    bf16 limit or None)."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    got = fa.flash_attention_bwd(*args, causal=causal, window=win)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(*args, causal=causal, window=win)
    errs, shares = [], []
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        check(a.dtype == dtype and a.shape == b.shape, f"{what} {name}")
        if dtype == torch.float32:
            errs.append(held(a, b, 1e-4, f"{what}: {name} vs plain"))
        else:
            e, sh = held_bf16(a, b, f"{what}: {name} vs plain")
            errs.append(e)
            shares.append(sh)
    return max(errs), max(shares, default=None)


def bwd_window_control(args, window, shape) -> dict:
    """The bf16 backward limit's power: the plain gradient of the
    ``window - 1`` attention against the ``window`` one on the same bf16
    ``args`` must exceed the limit in each of dq, dk and dv."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v, do = args[:4]
    want = fa.flash_attention_bwd_plain(*args, causal=True, window=window)
    out1, lse1 = fa.flash_attention_fwd_plain(q, k, v, causal=True,
                                              window=window - 1)
    other = fa.flash_attention_bwd_plain(q, k, v, do, out1, lse1,
                                         causal=True, window=window - 1)
    control = {}
    for name, a, b in zip(("dq", "dk", "dv"), other, want):
        gap = (a.double() - b.double()).abs()
        control[name] = dict(max_abs_err=float(gap.max()), share=float(
            (gap / (BF16_ATOL + BF16_RTOL * b.double().abs())).max()))
    print(f"[check] bf16 backward limit control, {shape}, window "
          f"{window - 1} against {window}: {json.dumps(control)} (each "
          f"share must exceed 1)", flush=True)
    check(all(c["share"] > 1.0 for c in control.values()),
          f"the bf16 limit passes the window - 1 gradient at {shape}")
    return control


def two_d(dev) -> dict:
    """The 2-D main path, counted; then its checks and timings,
    uncounted.  Returns the ``stencil2d`` entry of the ``kernels``
    line."""
    import torch
    import torch.nn.functional as F

    from repro_torch.api import Boundary, compile_stencil
    from repro_torch.core.roofline import H100
    from repro_torch.core.stencil_spec import TABLE3_DEPTHS, get
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import stencil2d as st
    from repro_torch.kernels import stencil3d as st3
    from repro_torch.stencils.data import init_domain

    # ---- the 2-D main path, counted -------------------------------------
    names = ["j2d5pt", "j2d9pt", "j2d9pt-gol", "j2d25pt"]
    cases = {}
    st.ebisu2d_padded.launches = 0
    st3.ebisu3d_padded.launches = 0
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd_dq.launches = 0
    fa.flash_attention_bwd_dkdv.launches = 0
    for name in names:
        spec = get(name)
        t = TABLE3_DEPTHS[name]["ebisu"]
        before = st.ebisu2d_padded.launches
        t0 = time.perf_counter()
        prog = compile_stencil(spec, spec.domain, t=t)
        x = init_domain(spec, device=dev, seed=0)
        y1 = prog.apply(x)
        yT = prog.run(x, 2 * t + 1)
        torch.cuda.synchronize()
        cases[name] = dict(prog=prog, x=x, y1=y1, yT=yT, t=t,
                           launches=st.ebisu2d_padded.launches - before,
                           host_s=time.perf_counter() - t0)
    j5 = get("j2d5pt")
    x5 = cases["j2d5pt"]["x"]
    prog_p = compile_stencil(j5, j5.domain, t=12,
                             boundary=Boundary.periodic())
    y_per = prog_p.run(x5, 25)
    prog_d = compile_stencil(j5, j5.domain, t=12, dtype=torch.float64)
    x5d = x5.double()
    y_d1 = prog_d.apply(x5d)
    y_dT = prog_d.run(x5d, 25)
    # a batch through run_batched: one launch a sweep for the whole batch
    prog5 = cases["j2d5pt"]["prog"]
    xs = torch.stack([init_domain(j5, device=dev, seed=i)
                      for i in range(BATCH_2D[1])])
    before = st.ebisu2d_padded.launches
    y_b = prog5.run_batched(xs, 25)
    batched_launches = st.ebisu2d_padded.launches - before
    # the caller's padded carry: two sweeps of 12
    xp5 = torch.zeros(prog5.padded_shape, device=dev)
    xp5[:j5.domain[0], :j5.domain[1]] = x5
    before = st.ebisu2d_padded.launches
    y_pad = prog5.run_padded(xp5, 24)[:j5.domain[0], :j5.domain[1]].clone()
    padded_launches = st.ebisu2d_padded.launches - before
    del xp5
    # the large tap sets, each run(2t+1) at the plan's depth: 3 sweeps
    large = {}
    for name, spec in large_tap_sets().items():
        if spec.ndim != 2:
            continue
        before = st.ebisu2d_padded.launches
        prog = compile_stencil(spec, LARGE_DOMAIN_2D)
        x = init_domain(spec, LARGE_DOMAIN_2D, device=dev, seed=0)
        y = prog.run(x, 2 * prog.t + 1)
        large[name] = dict(prog=prog, x=x, y=y, steps=2 * prog.t + 1,
                           launches=st.ebisu2d_padded.launches - before)
    torch.cuda.synchronize()
    launches = st.ebisu2d_padded.launches
    print(f"[main path] stencil2d launches: {launches} (run_batched of "
          f"{BATCH_2D[1]} fields: {batched_launches}; run_padded: "
          f"{padded_launches}; large tap sets: "
          f"{ {n: c['launches'] for n, c in large.items()} })", flush=True)
    check(st3.ebisu3d_padded.launches == 0
          and fa.flash_attention_fwd.launches == 0
          and fa.flash_attention_bwd_dq.launches == 0
          and fa.flash_attention_bwd_dkdv.launches == 0,
          "the 2-D path launched another kernel")
    # apply = 1 sweep; run(2t+1) = sweeps of t, t, 1 — for every program
    for name, c in cases.items():
        check(c["launches"] == 4, f"{name}: {c['launches']} launches, not 4")
    check(batched_launches == 3, f"run_batched of {BATCH_2D[1]} fields: "
          f"{batched_launches} launches, not one a sweep (3)")
    check(padded_launches == 2, f"run_padded(24): {padded_launches} "
          "launches, not 2")
    for name, c in large.items():
        check(c["launches"] == 3, f"{name}: {c['launches']} launches, not 3")
    want = 4 * len(names) + 3 + 4 + 3 + 2 + 3 * len(large)
    check(launches == want,
          f"main path launched the kernel {launches} times, not {want}")

    # ---- correctness, uncounted -----------------------------------------
    max_err = 0.0

    for name, c in cases.items():
        spec, prog, x, t = get(name), c["prog"], c["x"], c["t"]
        check(c["y1"].shape == x.shape and c["yT"].shape == x.shape,
              f"{name}: output shape")
        held(c["y1"], ref.reference(x, spec, t), 1e-4,
             f"{name} apply(t={t}) vs oracle")
        held(c["yT"], ref.reference(x, spec, 2 * t + 1), 1e-4,
             f"{name} run({2 * t + 1}) vs oracle")
        g = prog.geometry()
        (bh, bw), (hp, wp) = g["block"], g["padded"]
        xp = torch.zeros((hp, wp), dtype=torch.float32, device=dev)
        xp[:x.shape[0], :x.shape[1]] = x
        got = st.ebisu2d_padded(xp, spec, t, height=x.shape[0],
                                width=x.shape[1], bh=bh, bw=bw)
        again = st.ebisu2d_padded(xp, spec, t, height=x.shape[0],
                                  width=x.shape[1], bh=bh, bw=bw)
        want = st.ebisu2d_padded_plain(xp, spec, t, height=x.shape[0],
                                       width=x.shape[1])
        max_err = max(max_err, held(got, want, 1e-4,
                                    f"{name} kernel vs plain sweep"))
        check(torch.equal(got, again), f"{name}: a second launch differs")
        print(f"[check] {name} kernel: a second launch equal bit for bit",
              flush=True)
        del got, again, want
        c.update(xp=xp, geometry=g)
    held(y_per, ref.reference(x5, j5, 25, boundary=Boundary.periodic()),
         1e-4, "j2d5pt periodic run(25) vs oracle")
    held(y_d1, ref.reference(x5d, j5, 12), 1e-10, "j2d5pt f64 apply(12)")
    held(y_dT, ref.reference(x5d, j5, 25), 1e-10, "j2d5pt f64 run(25)")
    check(y_b.shape == xs.shape, "run_batched: output shape")
    for i in range(len(xs)):
        held(y_b[i], ref.reference(xs[i], j5, 25), 1e-4,
             f"j2d5pt run_batched field {i} vs oracle")
    del y_b
    check(torch.equal(y_pad, prog5.run(x5, 24)), "run_padded(24) differs "
          "from run(24)")
    print("[check] j2d5pt run_padded(24) equal to run(24), bit for bit",
          flush=True)
    del y_pad
    g = prog_d.geometry()
    xpd = torch.zeros(g["padded"], dtype=torch.float64, device=dev)
    xpd[:x5d.shape[0], :x5d.shape[1]] = x5d
    max_err = max(max_err, held(
        st.ebisu2d_padded(xpd, j5, 12, height=j5.domain[0],
                          width=j5.domain[1], bh=g["block"][0],
                          bw=g["block"][1]),
        st.ebisu2d_padded_plain(xpd, j5, 12, height=j5.domain[0],
                                width=j5.domain[1]),
        1e-10, "j2d5pt f64 kernel vs plain sweep"))

    # ---- timing, uncounted ----------------------------------------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    buf = torch.empty_like(cases["j2d5pt"]["xp"])
    src = cases["j2d5pt"]["xp"]
    copy_ms = median_ms(lambda: buf.copy_(src), 20, 3)
    copy_bps = 2 * src.numel() * src.element_size() / (copy_ms * 1e-3)
    print(f"[timing] device-to-device copy {copy_bps / 1e9:.1f} GB/s",
          flush=True)
    rows = []
    for name, c in cases.items():
        spec, t, x, xp, g = get(name), c["t"], c["x"], c["xp"], c["geometry"]
        (bh, bw), (hp, wp) = g["block"], g["padded"]
        height, width = x.shape
        out = torch.empty_like(xp)
        kern_ms = median_ms(lambda: st.ebisu2d_padded(
            xp, spec, t, height=height, width=width, bh=bh, bw=bw, out=out),
            20, 3)
        plain_ms = median_ms(lambda: st.ebisu2d_padded_plain(
            xp, spec, t, height=height, width=width), 10, 1)
        rad = spec.radius
        w = torch.zeros((1, 1, 2 * rad + 1, 2 * rad + 1), device=dev)
        for (dy, dx), coef in spec.taps:
            w[0, 0, dy + rad, dx + rad] = coef

        def library(v=x[None, None]):
            for _ in range(t):
                v = F.conv2d(v, w, padding=rad)
            return v

        lib_ms = median_ms(library, 10, 1)
        held(library()[0, 0], c["y1"], 1e-4, f"{name} conv2d yardstick")
        run_ms = median_ms(lambda: c["prog"].run(x, 2 * t + 1), 5, 1)
        nbytes = (height * width + hp * wp) * xp.element_size()
        flops = spec.flops_per_cell * t * height * width
        t_bytes, t_ops = nbytes / H100.b_gm, flops / H100.thr_cmp
        # the paper's own setting: the same sweep in f64, at the f64 tile
        gd = compile_stencil(spec, spec.domain, t=t,
                             dtype=torch.float64).geometry()
        xpd = torch.zeros(gd["padded"], dtype=torch.float64, device=dev)
        xpd[:height, :width] = x
        outd = torch.empty_like(xpd)
        ms_f64 = median_ms(lambda: st.ebisu2d_padded(
            xpd, spec, t, height=height, width=width, bh=gd["block"][0],
            bw=gd["block"][1], out=outd), 20, 3)
        bound_f64 = max((height * width + xpd.numel()) * 8 / H100.b_gm,
                        flops / H100.thr_cmp_fp64)
        # the f32 sweep at the f64 tile: the tile's cost apart from the type
        xpf, outf = xpd.float(), outd.float()
        del xpd, outd
        held(st.ebisu2d_padded(xpf, spec, t, height=height, width=width,
                               bh=gd["block"][0], bw=gd["block"][1],
                               out=outf)[:height, :width], c["y1"], 1e-4,
             f"{name} f32 kernel at the f64 tile vs apply")
        ms_f32_small = median_ms(lambda: st.ebisu2d_padded(
            xpf, spec, t, height=height, width=width, bh=gd["block"][0],
            bw=gd["block"][1], out=outf), 20, 3)
        del xpf, outf
        row = dict(stencil=name, t=t, domain=[height, width],
                   tile=[bh, bw], padded=[hp, wp],
                   smem_bytes=g["smem_bytes"], ms=kern_ms,
                   plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=max(t_bytes, t_ops) * 1e3,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bound_copy_ms=max(nbytes / copy_bps, t_ops) * 1e3,
                   roofline_share=max(t_bytes, t_ops) / (kern_ms * 1e-3),
                   gb_per_s=nbytes / (kern_ms * 1e-3) / 1e9,
                   cell_steps_per_s=height * width * t / (kern_ms * 1e-3),
                   tile_f64=list(gd["block"]), ms_f64=ms_f64,
                   ms_f32_at_f64_tile=ms_f32_small,
                   bound_ms_f64=bound_f64 * 1e3,
                   launches=c["launches"], run_steps=2 * t + 1,
                   run_ms=run_ms,
                   run_cell_steps_per_s=height * width * (2 * t + 1)
                   / (run_ms * 1e-3),
                   host_s_first_call=c["host_s"])
        rows.append(row)
        print("[timing] " + json.dumps(row), flush=True)
        model_2d(name, st.tile_schedule(spec, t, bh, bw, height, width),
                 kern_ms)

    batched = batched_vs_looped(prog5, xs, 25, "j2d5pt at 8352^2")
    del xs
    large_rows, err = large_set_rows(dev, large, st.ebisu2d_padded,
                                     st.ebisu2d_padded_plain, held)
    max_err = max(max_err, err)
    entry_2d = kernel_entry("stencil2d", SOURCE, REPLACES, launches,
                            max_err, rows,
                            "sums of one sweep of each 2-D Table-2 stencil "
                            "at its Table-2 domain and EBISU depth, f32; "
                            "the batched run and the large tap sets are "
                            "listed apart", batched=batched,
                            large_taps=large_rows)
    del cases, x5, x5d, y_per, y_d1, y_dT, buf, src, large
    torch.cuda.empty_cache()
    return entry_2d


def kernel_entry(name, source, replaces, launches, max_err, rows,
                 times_are, **extra) -> dict:
    """One kernel's object of the ``kernels`` line: the per-stencil rows
    and their sums."""
    total = {k: sum(r[k] for r in rows)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches, "max_abs_err": max_err,
        "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": ("bytes" if sum(r["bound_by"] == "bytes" for r in rows)
                     * 2 >= len(rows) else "operations"),
        "library_ms": total["library_ms"], "times_are": times_are,
        "per_stencil": rows, **extra}


def model_2d(name, sched, ms) -> None:
    """The ``[model]`` line of a 2-D sweep: what its CTAs compute, counted
    from the launch geometry (``stencil2d.tile_schedule``, not measured):
    the trapezoid's cell-updates and those computed (the overlapping last
    row block included), the rows a thread computes, each step's lane use
    and the shared reads per cell-update; and the trapezoid's count over
    the measured ms."""
    steps = sched["steps"]
    print(f"[model] stencil2d {name}: {sched['ctas']} CTAs "
          f"({sched['interior_ctas']} interior), R = "
          f"{sched['rows_per_thread']} rows a thread, "
          f"{sched['cell_updates']} cell-updates (counted), "
          f"{sched['computed_updates']} computed, "
          f"{sched['shared_reads'] / sched['cell_updates']:.4g} shared "
          "reads a cell-update, lane use by step "
          f"{[round(st['lane_use'], 3) for st in steps]} (rows "
          f"{[st['rows'] for st in steps]}), "
          f"{sched['cell_updates'] / (ms * 1e-3):.4g} cell-updates a "
          f"second at the measured {ms:.4g} ms", flush=True)


def model_3d(name, threads, g, ms) -> None:
    """The ``[model]`` line of a 3-D sweep: the stencil applications its
    trapezoid schedule computes (counted from the launch geometry, not
    measured), and that count over the measured ms."""
    print(f"[model] stencil3d {name}: {threads} threads a CTA, "
          f"{g['cell_updates']} cell-updates (counted), "
          f"{g['cell_updates'] / (ms * 1e-3):.4g} a second at the measured "
          f"{ms:.4g} ms", flush=True)


def three_d(dev, held) -> dict:
    """The 3-D main path, counted; then its checks and timings,
    uncounted.  Returns the ``stencil3d`` entry of the ``kernels`` line."""
    import torch
    import torch.nn.functional as F

    from repro_torch.api import Boundary, compile_stencil
    from repro_torch.core.roofline import H100
    from repro_torch.core.stencil_spec import (TABLE3_DEPTHS, get,
                                               lift_2d_to_3d)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import stencil2d as st
    from repro_torch.kernels import stencil3d as st3
    from repro_torch.stencils.data import init_domain

    names = ["j3d7pt", "j3d13pt", "j3d17pt", "j3d27pt", "poisson"]
    cases = {}
    st.ebisu2d_padded.launches = 0
    st3.ebisu3d_padded.launches = 0
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd_dq.launches = 0
    fa.flash_attention_bwd_dkdv.launches = 0
    for name in names:
        spec = get(name)
        t = TABLE3_DEPTHS[name]["ebisu"]
        before = st3.ebisu3d_padded.launches
        t0 = time.perf_counter()
        prog = compile_stencil(spec, spec.domain, t=t)
        x = init_domain(spec, seed=0)
        y1 = prog.apply(x)
        yT = prog.run(x, 2 * t + 1)
        torch.cuda.synchronize()
        cases[name] = dict(prog=prog, x=x, y1=y1, yT=yT, t=t,
                           launches=st3.ebisu3d_padded.launches - before,
                           host_s=time.perf_counter() - t0)
    j7 = get("j3d7pt")
    x7 = cases["j3d7pt"]["x"]
    y_per = compile_stencil(j7, j7.domain, t=8,
                            boundary=Boundary.periodic()).run(x7, 17)
    prog_d = compile_stencil(j7, j7.domain, t=8, dtype=torch.float64)
    x7d = x7.double()
    y_d1 = prog_d.apply(x7d)
    y_dT = prog_d.run(x7d, 17)
    j5 = get("j2d5pt")
    prog_s = compile_stencil(j5, j5.domain, t=12, mode="stream")
    x5 = init_domain(j5, seed=0)
    before = st3.ebisu3d_padded.launches
    y_s = prog_s.apply(x5)
    stream_launches = st3.ebisu3d_padded.launches - before
    # a batch through run_batched: one launch a sweep for the whole batch
    prog7 = cases["j3d7pt"]["prog"]
    xs = torch.stack([init_domain(j7, seed=i)
                      for i in range(BATCH_3D[1])])
    before = st3.ebisu3d_padded.launches
    y_b = prog7.run_batched(xs, 17)
    batched_launches = st3.ebisu3d_padded.launches - before
    # the large tap set, run(2t+1) at the plan's depth: 3 sweeps
    large = {}
    for name, spec in large_tap_sets().items():
        if spec.ndim != 3:
            continue
        before = st3.ebisu3d_padded.launches
        prog = compile_stencil(spec, LARGE_DOMAIN_3D)
        x = init_domain(spec, LARGE_DOMAIN_3D, seed=0)
        y = prog.run(x, 2 * prog.t + 1)
        large[name] = dict(prog=prog, x=x, y=y, steps=2 * prog.t + 1,
                           launches=st3.ebisu3d_padded.launches - before)
    torch.cuda.synchronize()
    launches = st3.ebisu3d_padded.launches
    print(f"[main path 3-D] stencil3d launches: {launches} (run_batched of "
          f"{BATCH_3D[1]} fields: {batched_launches}; large tap sets: "
          f"{ {n: c['launches'] for n, c in large.items()} })", flush=True)
    check(st.ebisu2d_padded.launches == 0
          and fa.flash_attention_fwd.launches == 0
          and fa.flash_attention_bwd_dq.launches == 0
          and fa.flash_attention_bwd_dkdv.launches == 0,
          "the 3-D path launched another kernel")
    for name, c in cases.items():
        check(c["launches"] == 4, f"{name}: {c['launches']} launches, not 4")
    check(stream_launches == 1,
          f"stream apply: {stream_launches} launches, not 1")
    check(batched_launches == 3, f"run_batched of {BATCH_3D[1]} fields: "
          f"{batched_launches} launches, not one a sweep (3)")
    for name, c in large.items():
        check(c["launches"] == 3, f"{name}: {c['launches']} launches, not 3")
    want = 4 * len(names) + 3 + 4 + 1 + 3 + 3 * len(large)
    check(launches == want,
          f"3-D path launched the kernel {launches} times, not {want}")

    # ---- correctness, uncounted -----------------------------------------
    max_err = 0.0

    def kernel_vs_plain(spec, t, x, g, dtype, tol, what):
        """The kernel twice (bit-identical) and its plain version, on the
        main path's own padded input; returns the padded input."""
        xp = torch.zeros(g["padded"], dtype=dtype, device=dev)
        if x.dim() == 2:
            xp[:x.shape[0], 0, :x.shape[1]] = x
            shape = (x.shape[0], 1, x.shape[1])
        else:
            xp[:x.shape[0], :x.shape[1], :x.shape[2]] = x
            shape = tuple(x.shape)
        kw = dict(zip(("zdim", "ydim", "xdim"), shape))
        zc, ty, tx = g["block"]
        got = st3.ebisu3d_padded(xp, spec, t, zc=zc, ty=ty, tx=tx, **kw)
        again = st3.ebisu3d_padded(xp, spec, t, zc=zc, ty=ty, tx=tx, **kw)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"{what}: a second launch differs")
        err = held(got, st3.ebisu3d_padded_plain(xp, spec, t, **kw), tol,
                   f"{what} kernel vs plain sweep (repeat bit-identical)")
        return xp, err

    # each launch's block and shared memory, from the library's launcher
    launched = {}
    for name, spec, t, shape, g, itemsize in [
            (n, get(n), c["t"], get(n).domain, c["prog"].geometry(), 4)
            for n, c in cases.items()] + [
            ("j3d7pt f64", j7, 8, j7.domain, prog_d.geometry(), 8),
            ("j2d5pt stream", lift_2d_to_3d(j5), 12,
             (j5.domain[0], 1, j5.domain[1]), prog_s.geometry(), 4)]:
        block, smem = st3.launch_shape(spec, t, shape, g, itemsize)
        check(smem == g["kernel_smem_bytes"] and block == g["threads"],
              f"{name}: the launcher's block {block} and shared memory "
              f"{smem} are not the planner's {g['threads']} and "
              f"{g['kernel_smem_bytes']}")
        check(smem <= g["smem_bytes"],
              f"{name}: {smem} B of shared memory over the planner's budget")
        launched[name] = block, smem
        print(f"[build] stencil3d {name} launch: kernel_smem_bytes {smem} "
              f"of smem_bytes_3d {g['smem_bytes']}, {block} threads, "
              f"tile {list(g['block'])}", flush=True)
    for name, c in cases.items():
        spec, prog, x, t = get(name), c["prog"], c["x"], c["t"]
        check(c["y1"].shape == x.shape and c["yT"].shape == x.shape,
              f"{name}: output shape")
        held(c["y1"], ref.reference(x, spec, t), 1e-4,
             f"{name} apply(t={t}) vs oracle")
        held(c["yT"], ref.reference(x, spec, 2 * t + 1), 1e-4,
             f"{name} run({2 * t + 1}) vs oracle")
        c["geometry"] = prog.geometry()
        del c["yT"]
    held(y_per, ref.reference(x7, j7, 17, boundary=Boundary.periodic()),
         1e-4, "j3d7pt periodic run(17) vs oracle")
    held(y_d1, ref.reference(x7d, j7, 8), 1e-10, "j3d7pt f64 apply(8)")
    held(y_dT, ref.reference(x7d, j7, 17), 1e-10, "j3d7pt f64 run(17)")
    del y_per, y_d1, y_dT
    check(y_b.shape == xs.shape, "run_batched: output shape")
    for i in range(len(xs)):
        held(y_b[i], ref.reference(xs[i], j7, 17), 1e-4,
             f"j3d7pt run_batched field {i} vs oracle")
    del y_b
    g = prog_d.geometry()
    xpd, err = kernel_vs_plain(j7, 8, x7d, g, torch.float64, 1e-10,
                               "j3d7pt f64")
    max_err = max(max_err, err)
    del xpd, x7d
    held(y_s, ref.reference(x5, j5, 12), 1e-4,
         "j2d5pt stream apply(12) vs oracle")
    lifted = prog_s.geometry()
    xps, err = kernel_vs_plain(lift_2d_to_3d(j5), 12, x5, lifted,
                               torch.float32, 1e-4, "j2d5pt stream")
    max_err = max(max_err, err)
    torch.cuda.empty_cache()

    # ---- timing, uncounted, one stencil at a time -----------------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def bound(cells, padded, t, flops_per_cell, itemsize, fp64=False):
        nbytes = (cells + padded) * itemsize
        flops = flops_per_cell * t * cells
        t_bytes = nbytes / H100.b_gm
        t_ops = flops / (H100.thr_cmp_fp64 if fp64 else H100.thr_cmp)
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations"), nbytes

    rows = []
    for name in names:
        c = cases.pop(name)
        spec, t, x, g = get(name), c["t"], c["x"], c["geometry"]
        zc, ty, tx = g["block"]
        cells = x.numel()
        xp, err = kernel_vs_plain(spec, t, x, g, torch.float32, 1e-4, name)
        max_err = max(max_err, err)
        kw = dict(zip(("zdim", "ydim", "xdim"), x.shape))
        out = torch.empty_like(xp)
        kern_ms = median_ms(lambda: st3.ebisu3d_padded(
            xp, spec, t, zc=zc, ty=ty, tx=tx, out=out, **kw), 20, 3)
        plain_ms = median_ms(lambda: st3.ebisu3d_padded_plain(
            xp, spec, t, **kw), 5, 1)
        rad = spec.radius
        w = torch.zeros((1, 1) + (2 * rad + 1,) * 3, device=dev)
        for (dz, dy, dx), coef in spec.taps:
            w[0, 0, dz + rad, dy + rad, dx + rad] = coef

        def library(v=x[None, None]):
            for _ in range(t):
                v = F.conv3d(v, w, padding=rad)
            return v

        lib_ms = median_ms(library, 5, 1)
        held(library()[0, 0], c["y1"], 1e-4, f"{name} conv3d yardstick")
        del c["y1"]
        run_ms = median_ms(lambda: c["prog"].run(x, 2 * t + 1), 5, 1)
        b_s, b_by, nbytes = bound(cells, xp.numel(), t, spec.flops_per_cell,
                                  4)
        del xp, out
        gd = compile_stencil(spec, spec.domain, t=t,
                             dtype=torch.float64).geometry()
        xpd = torch.zeros(gd["padded"], dtype=torch.float64, device=dev)
        xpd[:x.shape[0], :x.shape[1], :x.shape[2]] = x
        outd = torch.empty_like(xpd)
        ms_f64 = median_ms(lambda: st3.ebisu3d_padded(
            xpd, spec, t, zc=gd["block"][0], ty=gd["block"][1],
            tx=gd["block"][2], out=outd, **kw), 20, 3)
        b64, _, _ = bound(cells, xpd.numel(), t, spec.flops_per_cell, 8,
                          fp64=True)
        del xpd, outd, x
        torch.cuda.empty_cache()
        row = dict(stencil=name, t=t, domain=list(spec.domain),
                   tile=[zc, ty, tx], grid=list(g["grid"]),
                   padded=list(g["padded"]), smem_bytes=g["smem_bytes"],
                   kernel_smem_bytes=launched[name][1],
                   ms=kern_ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=b_s * 1e3, bound_by=b_by,
                   roofline_share=b_s / (kern_ms * 1e-3),
                   gb_per_s=nbytes / (kern_ms * 1e-3) / 1e9,
                   gflop_per_s=spec.flops_per_cell * t * cells
                   / (kern_ms * 1e-3) / 1e9,
                   cell_steps_per_s=cells * t / (kern_ms * 1e-3),
                   tile_f64=list(gd["block"]), ms_f64=ms_f64,
                   bound_ms_f64=b64 * 1e3, launches=c["launches"],
                   run_steps=2 * t + 1, run_ms=run_ms,
                   run_cell_steps_per_s=cells * (2 * t + 1)
                   / (run_ms * 1e-3),
                   host_s_first_call=c["host_s"])
        rows.append(row)
        print("[timing] " + json.dumps(row), flush=True)
        model_3d(name, launched[name][0], g, kern_ms)

    # the stream sweep: j2d5pt at 8352² as 8352×1×8352, t=12
    zc, ty, tx = lifted["block"]
    kw = dict(zdim=j5.domain[0], ydim=1, xdim=j5.domain[1])
    spec_l = lift_2d_to_3d(j5)
    outs = torch.empty_like(xps)
    s_ms = median_ms(lambda: st3.ebisu3d_padded(
        xps, spec_l, 12, zc=zc, ty=ty, tx=tx, out=outs, **kw), 20, 3)
    s_plain = median_ms(lambda: st3.ebisu3d_padded_plain(
        xps, spec_l, 12, **kw), 5, 1)
    b_s, b_by, nbytes = bound(x5.numel(), xps.numel(), 12,
                              j5.flops_per_cell, 4)
    stream = dict(stencil="j2d5pt stream", t=12, domain=list(j5.domain),
                  tile=[zc, ty, tx], grid=list(lifted["grid"]),
                  padded=list(lifted["padded"]),
                  smem_bytes=lifted["smem_bytes"],
                  kernel_smem_bytes=launched["j2d5pt stream"][1],
                  ms=s_ms,
                  plain_ms=s_plain, bound_ms=b_s * 1e3, bound_by=b_by,
                  roofline_share=b_s / (s_ms * 1e-3),
                  gb_per_s=nbytes / (s_ms * 1e-3) / 1e9,
                  launches=stream_launches)
    print("[timing] " + json.dumps(stream), flush=True)
    model_3d("j2d5pt stream", launched["j2d5pt stream"][0], lifted, s_ms)
    del xps, outs
    torch.cuda.empty_cache()
    batched = batched_vs_looped(prog7, xs, 17, "j3d7pt at 2560x288x384")
    del xs
    large_rows, err = large_set_rows(dev, large, st3.ebisu3d_padded,
                                     st3.ebisu3d_padded_plain, held)
    max_err = max(max_err, err)
    return kernel_entry(
        "stencil3d", SOURCE_3D, REPLACES_3D, launches, max_err, rows,
        "sums of one sweep of each 3-D Table-2 stencil at 2560x288x384 "
        "and EBISU depth, f32; the stream sweep, the batched run and the "
        "large tap set are listed apart",
        kernel_smem_bytes={r["stencil"]: r["kernel_smem_bytes"]
                           for r in rows + [stream]},
        stream=stream, batched=batched, large_taps=large_rows)


def systems(dev) -> None:
    """The coupled systems (``repro_torch.systems``), which compute in plain
    torch through the tap engine and launch no kernel: each library system
    at 512² on the card held against the same program on the CPU in
    float64, then timed at 4096² in f32 (CUDA events, median)."""
    import numpy as np
    import torch

    from repro_torch.api import Boundary
    from repro_torch.kernels import stencil2d as st
    from repro_torch.kernels import stencil3d as st3
    from repro_torch.systems import compile_system, get_system, system_names

    zero_counts()
    for name in system_names():
        spec = get_system(name)
        t, steps = 4, 9
        for boundary in (Boundary.periodic(), Boundary.neumann()):
            rng = np.random.default_rng(0)
            arrs = {f: rng.uniform(0.2, 0.8, (512, 512)).astype(np.float32)
                    for f in spec.fields}
            card = compile_system(spec, (512, 512), t=t, boundary=boundary)
            got = card.run({f: torch.from_numpy(v).to(dev)
                             for f, v in arrs.items()}, steps)
            cpu = compile_system(spec, (512, 512), t=t, boundary=boundary,
                                 dtype=torch.float64)
            want = cpu.run({f: torch.from_numpy(v).double()
                            for f, v in arrs.items()}, steps)
            for f in spec.fields:
                check(got[f].device.type == "cuda", f"{name}: field {f} "
                      "left the card")
                held(got[f].cpu(), want[f], 1e-4,
                     f"system {name} {boundary!r} field {f} at 512^2, card "
                     "f32 vs CPU f64")
        big = {f: torch.rand((4096, 4096), generator=torch.Generator(
            device=dev).manual_seed(i), device=dev) * 0.6 + 0.2
            for i, f in enumerate(spec.fields)}
        prog = compile_system(spec, (4096, 4096), t=t,
                              boundary=Boundary.periodic())
        out = prog.run(big, steps)
        check(all(bool(torch.isfinite(v).all()) for v in out.values()),
              f"system {name}: non-finite output at 4096^2")
        ms = median_ms(lambda: prog.run(big, steps), 5, 1)
        row = dict(system=name, fields=len(spec.fields), domain=[4096, 4096],
                   t=t, steps=steps, boundary="periodic", dtype="float32",
                   ms=ms, cell_steps_per_s=4096 * 4096 * steps
                   / (ms * 1e-3), route="plain torch (no kernel)")
        print("[timing] " + json.dumps(row), flush=True)
        del big, out
    check(st.ebisu2d_padded.launches == 0
          and st3.ebisu3d_padded.launches == 0,
          "the systems phase launched a stencil kernel")


# the sharded phase: the paper's domains on a (2, 2) mesh of one card
SHARDED_2D = ("j2d5pt", 12, 25)          # (stencil, t, T)
SHARDED_3D = ("j3d7pt", 8, 17)
SHARDED_TOL = 1e-4                       # f32, run_sharded vs .run
SHARDED_ROUTE = ("plain torch per shard (the reference's own per-shard "
                 "compute)")


def sharded(dev) -> None:
    """``compile_stencil(..., mesh=)`` → ``run_sharded`` on a (2, 2) mesh
    of ``cuda:0`` × 4 at the paper's domains, counted: no stencil kernel
    launches, and the exchange counter reads ``planned_exchange_rounds(T,
    t) × 2 × 2``; a mesh of size 1 launches exactly ``.run``'s sweeps.
    Then, uncounted: each run within 1e-4 of ``.run`` on the card and
    equal to a second call bit for bit, the timings, and the refusal of a
    (2, 2) mesh without ``devices=`` on a one-card host."""
    import torch

    from repro_torch.api import (Boundary, compile_stencil,
                                 planned_exchange_rounds)
    from repro_torch.core.distributed import ppermute
    from repro_torch.core.stencil_spec import get
    from repro_torch.kernels import stencil2d as st
    from repro_torch.kernels import stencil3d as st3
    from repro_torch.launch.mesh import device_summary, make_stencil_mesh
    from repro_torch.stencils.data import init_domain

    mesh = make_stencil_mesh((2, 2), devices=[dev] * 4)
    name2, t2, steps2 = SHARDED_2D
    name3, t3, steps3 = SHARDED_3D
    cases = [(name2, t2, steps2, b) for b in (
        Boundary.dirichlet(0.0), Boundary.periodic(), Boundary.reflect())]
    cases.append((name3, t3, steps3, Boundary.dirichlet(0.0)))
    fields = {n: init_domain(get(n), device=dev, seed=0)
              for n in (name2, name3)}

    # ---- the sharded runs, counted --------------------------------------
    runs = []
    zero_counts()
    for name, t, steps, boundary in cases:
        spec = get(name)
        prog = compile_stencil(spec, spec.domain, t=t, mesh=mesh,
                               boundary=boundary)
        calls = ppermute.calls
        y = prog.run_sharded(fields[name], steps)
        torch.cuda.synchronize()
        runs.append(dict(prog=prog, y=y, steps=steps, boundary=boundary,
                         exchanges=ppermute.calls - calls))
    launched = st.ebisu2d_padded.launches + st3.ebisu3d_padded.launches
    print(f"[main path sharded] mesh (2, 2) devices="
          f"{device_summary(mesh.devices.flat)}: stencil launches "
          f"{launched}, exchanges "
          f"{[r['exchanges'] for r in runs]}", flush=True)
    check(launched == 0, f"run_sharded on a mesh of 4 shards launched "
          f"{launched} stencil kernels, not 0")
    for r in runs:
        want = planned_exchange_rounds(r["steps"], r["prog"].t) * 2 * 2
        check(r["exchanges"] == want, f"{r['prog'].spec.name} "
              f"{r['boundary']!r}: {r['exchanges']} exchanges, not {want}")
    # a mesh of size 1 is .run: the same launches
    spec2 = get(name2)
    one = compile_stencil(spec2, spec2.domain, t=t2, mesh=make_stencil_mesh(
        (1, 1), devices=[dev]))
    zero_counts()
    y_one = one.run_sharded(fields[name2], steps2)
    torch.cuda.synchronize()
    one_launches = st.ebisu2d_padded.launches
    single = compile_stencil(spec2, spec2.domain, t=t2)
    zero_counts()
    y_run = single.run(fields[name2], steps2)
    torch.cuda.synchronize()
    run_launches = st.ebisu2d_padded.launches
    print(f"[main path sharded] mesh (1, 1): stencil2d launches "
          f"{one_launches} (.run: {run_launches})", flush=True)
    check(one_launches == run_launches == 3, f"mesh of size 1: "
          f"{one_launches} launches, .run {run_launches}, not 3 each")
    check(torch.equal(y_one, y_run), "mesh of size 1 differs from .run")

    # ---- checks and timings, uncounted ----------------------------------
    for r in runs:
        prog, spec = r["prog"], r["prog"].spec
        x = fields[spec.name]
        plain = compile_stencil(spec, spec.domain, t=prog.t,
                                boundary=r["boundary"])
        check(r["y"].device == x.device, "run_sharded left the card")
        check(r["y"].shape == x.shape, f"{spec.name}: output shape")
        want = plain.run(x, r["steps"])
        what = (f"{spec.name} {r['boundary']!r} run_sharded({r['steps']}) "
                f"on (2, 2) cuda:0 x4 vs .run")
        held(r["y"], want, SHARDED_TOL, what)
        again = prog.run_sharded(x, r["steps"])
        check(torch.equal(again, r["y"]), f"{what}: a second call differs")
        print(f"[check] {what}: a second call equal bit for bit",
              flush=True)
        del again
        ms = median_ms(lambda: prog.run_sharded(x, r["steps"]), 3, 1)
        run_ms = median_ms(lambda: plain.run(x, r["steps"]), 3, 1)
        row = dict(phase="sharded", stencil=spec.name,
                   boundary=repr(r["boundary"]), domain=list(spec.domain),
                   mesh=[2, 2], devices=device_summary(mesh.devices.flat),
                   t=prog.t, steps=r["steps"], exchanges=r["exchanges"],
                   run_sharded_ms=ms, run_ms=run_ms,
                   sharded_over_run=ms / run_ms, route=SHARDED_ROUTE)
        print("[timing] " + json.dumps(row), flush=True)
        del want
    n_cards = torch.cuda.device_count()
    try:
        make_stencil_mesh((2, 2))
        check(n_cards >= 4, "make_stencil_mesh((2, 2)) without devices= "
              f"took a mesh on {n_cards} cards")
        print(f"[check] make_stencil_mesh((2, 2)) without devices=: "
              f"{n_cards} cards, no refusal", flush=True)
    except RuntimeError as e:
        check(n_cards < 4 and "devices=" in str(e), f"refusal: {e}")
        print(f"[check] make_stencil_mesh((2, 2)) without devices= on "
              f"{n_cards} card(s) refuses: {e}", flush=True)


# the campaign phase: j2d5pt at 8352^2 and j3d7pt at 2560x288x384, f32
CAMPAIGN_2D = ("j2d5pt", 12, 25)
CAMPAIGN_3D = ("j3d7pt", 8, 17)
CAMPAIGN_CLI_SCALE = 2        # the CLI kill-and-resume at 4176^2


def campaign(dev) -> None:
    """Resumable campaigns on the card, counted: fresh campaigns with
    ``every`` = 1 and 2, a crash after leg 2 and ``resume_campaign``, a
    poisoned leg rolled back, each against ``.run`` bit for bit, and the
    stencil launches equal to the sweeps of the legs run, exactly; an
    elastic restore of a sharded campaign from a (2, 2) ``cuda:0`` mesh
    onto (2, 1), within 1e-4 of ``.run``.  Then the CLI killed after leg
    2 (exit 137) in a subprocess on the card and resumed, bit for bit a
    straight run's ``--out``, and the campaign's time beside ``.run``'s,
    its checkpoints written.  Checkpoints go to a temporary directory
    that is removed afterwards."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.api import compile_stencil, sweep_schedule
    from repro_torch.core.stencil_spec import get
    from repro_torch.faults import FaultConfig, FaultInjector, SimClock
    from repro_torch.kernels import stencil2d as st
    from repro_torch.kernels import stencil3d as st3
    from repro_torch.launch.mesh import make_stencil_mesh
    from repro_torch.resilient import (CampaignStore, leg_schedule,
                                       resume_campaign)
    from repro_torch.stencils.data import init_domain

    class Crash(Exception):
        pass

    def sweeps(steps, t):
        return len(sweep_schedule(steps, t))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        def store():
            """An empty store in place of the last one (whose campaign
            has ended and waited for its writes): one checkpoint kept,
            which is all a rollback here needs, so the disk holds one
            field at a time."""
            path = os.path.join(tmp, "ck")
            shutil.rmtree(path, ignore_errors=True)
            return CampaignStore(path, keep=1)

        results, expect = [], 0
        zero_counts()
        for name, t, steps in (CAMPAIGN_2D, CAMPAIGN_3D):
            spec = get(name)
            prog = compile_stencil(spec, spec.domain, t=t)
            x = init_domain(spec, device=dev, seed=0)
            legs = leg_schedule(steps, t)
            full = sum(sweeps(n, t) for _, n in legs)
            for every in ((1, 2) if spec.ndim == 2 else (1,)):
                rep = prog.run_resumable(x, steps, store=store(),
                                         every=every)
                results.append((prog, x, steps, f"fresh every={every}",
                                rep.result))
                expect += sum(sweeps(n, t)
                              for _, n in leg_schedule(steps, t, every))
            s = store()

            def crash(leg, done, s=s):
                if leg == 2:
                    s.wait()
                    raise Crash()

            try:
                prog.run_resumable(x, steps, store=s, on_leg=crash)
                check(False, f"{name}: the crash hook never fired")
            except Crash:
                pass
            rep = resume_campaign(prog, s)
            check(rep.resumed_from == 2, f"{name}: resumed from "
                  f"{rep.resumed_from}, not leg 2")
            results.append((prog, x, steps, "crash after leg 2, resumed",
                            rep.result))
            expect += full
            if spec.ndim == 2:
                rep = prog.run_resumable(
                    x, steps, store=store(), clock=SimClock(),
                    faults=FaultInjector(FaultConfig(nan_at_leg=(2,))))
                check(rep.rollbacks == 1 and rep.retries == 1,
                      f"{name}: poisoned leg 2: {rep.rollbacks} rollbacks")
                results.append((prog, x, steps, "leg 2 poisoned, rolled "
                                "back", rep.result))
                expect += full + sweeps(legs[1][1], t)
        torch.cuda.synchronize()
        launched = st.ebisu2d_padded.launches + st3.ebisu3d_padded.launches
        print(f"[main path campaign] stencil launches {launched} "
              f"(stencil2d {st.ebisu2d_padded.launches}, stencil3d "
              f"{st3.ebisu3d_padded.launches}); the legs' sweeps: {expect}",
              flush=True)
        check(launched == expect, f"campaigns launched {launched} stencil "
              f"kernels, not the legs' {expect} sweeps")

        # ---- checks, uncounted ------------------------------------------
        for prog, x, steps, what, got in results:
            want = prog.run(x, steps)
            check(got.device == x.device and torch.equal(got, want),
                  f"{prog.spec.name} campaign ({what}) differs from .run")
            print(f"[check] {prog.spec.name} campaign ({what}): equal to "
                  f".run({steps}) bit for bit", flush=True)
        del results

        # elastic restore of a sharded campaign: (2, 2) -> (2, 1)
        name, t, steps = CAMPAIGN_2D
        spec = get(name)
        x = init_domain(spec, device=dev, seed=0)
        mesh = make_stencil_mesh((2, 2), devices=[dev] * 4)
        progm = compile_stencil(spec, spec.domain, t=t, mesh=mesh)
        rep = progm.run_sharded_resumable(
            x, steps, store=store(), clock=SimClock(),
            faults=FaultInjector(FaultConfig(device_loss_at_leg=(2,))))
        check(rep.mesh_history == [(2, 1)],
              f"elastic restore: mesh history {rep.mesh_history}")
        plain = compile_stencil(spec, spec.domain, t=t)
        held(rep.result, plain.run(x, steps), 1e-4,
             f"{name} sharded campaign, device lost before leg 2, restored "
             "onto (2, 1) cuda:0, vs .run")

        # the CLI: killed after leg 2's checkpoint, resumed
        from repro_torch.launch import stencil_run

        args = ["--stencil", name, "--scale", str(CAMPAIGN_CLI_SCALE),
                "--t", str(t), "--T", str(steps)]
        straight = os.path.join(tmp, "straight.npy")
        resumed = os.path.join(tmp, "resumed.npy")
        stencil_run.main(args + ["--checkpoint-dir",
                                 os.path.join(tmp, "cli_a"), "--out",
                                 straight])
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        base = [sys.executable, "-m", "repro_torch.launch.stencil_run"] + args
        ck = os.path.join(tmp, "cli_b")
        r = subprocess.run(base + ["--checkpoint-dir", ck,
                                   "--kill-after-leg", "2"],
                           env=env, capture_output=True, text=True,
                           timeout=300)
        check(r.returncode in (-9, 137), f"CLI --kill-after-leg 2 exited "
              f"{r.returncode}, not 137: {r.stderr[-2000:]}")
        print(f"[check] CLI --kill-after-leg 2: exit "
              f"{128 - r.returncode if r.returncode < 0 else r.returncode} "
              f"({r.stdout.strip().splitlines()[-1]})", flush=True)
        r = subprocess.run(base + ["--checkpoint-dir", ck, "--resume",
                                   "auto", "--out", resumed],
                           env=env, capture_output=True, text=True,
                           timeout=300)
        check(r.returncode == 0, f"CLI resume failed: {r.stderr[-2000:]}")
        check("resumed@leg2" in r.stdout, f"CLI resume: {r.stdout}")
        check(bool((np.load(straight) == np.load(resumed)).all()),
              "CLI: the resumed --out differs from the straight run's")
        print(f"[check] CLI resumed ({r.stdout.strip().splitlines()[0]}) "
              "--out equal to a straight run's, bit for bit", flush=True)

        # timing: a campaign with its checkpoints written, beside .run
        # (the 3-D field is 1.1 GB a checkpoint: one timed campaign)
        for (name, t, steps), reps in ((CAMPAIGN_2D, 3), (CAMPAIGN_3D, 1)):
            spec = get(name)
            prog = compile_stencil(spec, spec.domain, t=t)
            x = init_domain(spec, device=dev, seed=0)
            ms = median_ms(lambda: prog.run_resumable(
                x, steps, store=store(), resume="never"), reps, 0)
            run_ms = median_ms(lambda: prog.run(x, steps), 3, 1)
            row = dict(phase="campaign", stencil=name, reps=reps,
                       domain=list(spec.domain), t=t, steps=steps, every=1,
                       legs=len(leg_schedule(steps, t)),
                       checkpoints=len(leg_schedule(steps, t)) + 1,
                       campaign_ms=ms, run_ms=run_ms,
                       campaign_over_run=ms / run_ms,
                       route="the stencil kernel, one launch a sweep")
            print("[timing] " + json.dumps(row), flush=True)


# (stencil, t, steps, requests, domain: None for the paper's); the small
# j2d5pt domain is where a sweep's GPU time no longer hides the host's
# per-launch work, which coalescing shares among the requests
SERVE_CASES = (("j2d5pt", 12, 25, 8, None), ("j2d5pt", 12, 25, 8, (512, 512)),
               ("j3d7pt", 8, 17, 2, None))
SERVE_TENANTS = ("alice", "bob", "carol", "dave")
SERVE_TOL = 1e-4                        # f32, a served result vs .run


def serve(dev) -> None:
    """The stencil service on the card (``repro_torch.serve``), f32.

    (a) Coalescing: requests for one stencil from four tenants through
    ``ServiceCore`` on the monotonic clock, ``max_batch`` 8 and
    ``max_cells`` raised to the paper's domain: 8 j2d5pt fields at 8352²
    (t = 12, 25 steps), the same at 512², then 2 j3d7pt fields at
    2560×288×384 (t = 8, 17 steps).  Counted: the batch launches one
    sweep for all of them (3), against 3 a field for a loop of
    ``.run``; each result within 1e-4 of its field's ``.run``; the counted (first) pass's p50 latency,
    then p50/p99 latency and requests/s of a warm pass, and the
    coalesced pass's ms beside the loop's (CUDA events, median of 3),
    with its parts timed alone: the stack of the fields, the batched
    chain and the guard's finiteness reduction.  (b) The seeded faulty
    tape (``launch.serve_stencil.run(200, faults=True, seed=7)``)
    resolves every request.  (c) 32 requests through the asyncio front door
    (``StencilService``, dispatches on worker threads) all resolve."""
    import asyncio

    import torch

    from repro_torch.api import compile_stencil, sweep_schedule
    from repro_torch.core.stencil_spec import get
    from repro_torch.faults import MonotonicClock
    from repro_torch.kernels import stencil2d as st
    from repro_torch.kernels import stencil3d as st3
    from repro_torch.launch import serve_stencil
    from repro_torch.serve.stencil_service import (ServeRequest,
                                                   ServiceConfig,
                                                   ServiceCore)
    from repro_torch.stencils.data import init_domain

    for name, t, steps, n, domain in SERVE_CASES:
        spec = get(name)
        shape = domain or spec.domain
        wrapper, other = ((st.ebisu2d_padded, st3.ebisu3d_padded)
                          if spec.ndim == 2 else
                          (st3.ebisu3d_padded, st.ebisu2d_padded))
        # every request is in before the first poll, so the batch needs no
        # window: a window would only sleep on the monotonic clock
        cfg = ServiceConfig(max_batch=8, batch_window_ms=0.0,
                            max_cells=math.prod(shape), max_queue=64,
                            max_inflight_per_tenant=64, device=str(dev))
        xs = [init_domain(spec, shape, device=dev, seed=i)
              for i in range(n)]

        def served():
            core = ServiceCore(cfg, clock=MonotonicClock())
            tks = [core.submit(ServeRequest(
                spec, x, total_t=steps, t=t,
                tenant=SERVE_TENANTS[i % len(SERVE_TENANTS)]))
                for i, x in enumerate(xs)]
            core.drain()
            return core, tks

        sweeps = len(sweep_schedule(steps, t))
        zero_counts()
        core, tks = served()
        torch.cuda.synchronize()
        launched, stray = wrapper.launches, other.launches
        stats = core.stats()
        what = f"{name} " + "x".join(str(d) for d in shape)
        print(f"[main path] serve {what} {n} requests x {steps} steps "
              f"(t={t}) from {min(n, len(SERVE_TENANTS))} tenants: "
              f"{wrapper.__name__} launches {launched}, "
              f"{other.__name__} {stray}; batches {stats['batches']}",
              flush=True)
        check(all(tk.ok for tk in tks), f"serve {what}: a request failed: "
              f"{[tk.error for tk in tks if not tk.ok]}")
        check(all(tk.batched_width == n for tk in tks),
              f"serve {what}: not one batch of {n}")
        check(launched == sweeps and stray == 0,
              f"serve {what}: {launched} launches, want {sweeps} (one a "
              "sweep for the whole batch)")
        prog = compile_stencil(spec, shape, t=t)
        err = 0.0
        for i, (x, tk) in enumerate(zip(xs, tks)):
            err = max(err, held(tk.result(), prog.run(x, steps), SERVE_TOL,
                                f"serve {what} request {i} vs .run"))
        del tks, core
        zero_counts()
        loop = [prog.run(x, steps) for x in xs]
        torch.cuda.synchronize()
        check(wrapper.launches == n * sweeps,
              f"serve {what}: a loop of .run launched {wrapper.launches}")
        print(f"[check] serve {what}: {launched} launches for the batch "
              f"against {wrapper.launches} for a loop of .run; max|err| "
              f"vs .run {err:.3e}", flush=True)
        del loop
        coalesced_ms = median_ms(served, 3, 0)
        looped_ms = median_ms(lambda: [prog.run(x, steps) for x in xs], 3, 1)
        warm = served()[0].stats()
        # the coalesced pass's parts, each alone: the stack of the fields,
        # the batched chain, the guard's one finiteness reduction
        stack_ms = median_ms(lambda: torch.stack(xs), 3, 1)
        xb = torch.stack(xs)
        batched_ms = median_ms(lambda: prog.run_batched(xb, steps), 3, 1)
        yb = prog.run_batched(xb, steps)
        def finite_rows():
            lo, hi = torch.aminmax(yb.reshape(n, -1), dim=1)
            return (lo.isfinite() & hi.isfinite()).tolist()

        finite_ms = median_ms(finite_rows, 3, 1)
        del xb, yb
        row = dict(stencil=what, requests=n, steps=steps, t=t,
                   domain=list(shape), batch_launches=launched,
                   loop_launches=n * sweeps,
                   first_p50_latency_ms=stats["p50_latency_ms"],
                   p50_latency_ms=warm["p50_latency_ms"],
                   p99_latency_ms=warm["p99_latency_ms"],
                   requests_per_sec=warm.get("requests_per_sec"),
                   coalesced_ms=coalesced_ms, looped_ms=looped_ms,
                   looped_over_coalesced=looped_ms / coalesced_ms,
                   stack_ms=stack_ms, run_batched_ms=batched_ms,
                   finite_ms=finite_ms,
                   rest_ms=coalesced_ms - stack_ms - batched_ms - finite_ms,
                   max_abs_err=err)
        print("[timing] serve " + json.dumps(row), flush=True)
        del xs
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    zero_counts()
    bad = serve_stencil.run(200, faults=True, seed=7, show=False,
                            device=str(dev))
    torch.cuda.synchronize()
    print(f"[check] serve faulty tape: 200 requests, seed 7, {bad} "
          f"unresolved, {time.perf_counter() - t0:.2f}s, launches "
          f"stencil2d {st.ebisu2d_padded.launches} stencil3d "
          f"{st3.ebisu3d_padded.launches}", flush=True)
    check(bad == 0, f"serve faulty tape: {bad} robustness violations")
    zero_counts()
    rc = asyncio.run(serve_stencil.run_asyncio(
        32, seed=3, rate_hz=2000.0, guard="retry_solo", device=str(dev)))
    torch.cuda.synchronize()
    launched = st.ebisu2d_padded.launches + st3.ebisu3d_padded.launches
    print(f"[check] serve asyncio front door: 32 requests, rc {rc}, "
          f"{launched} launches from worker threads", flush=True)
    check(rc == 0 and launched > 0, "serve asyncio: a request unresolved")


TUNE_CASES = ("j2d5pt", "j3d7pt")      # at their paper domains
TUNE_BUDGET = 64


def tune(dev) -> None:
    """Measured tuning on the card (``repro_torch.tuning``): ``tune()``
    of j2d5pt at 8352² and j3d7pt at 2560×288×384, budget 64 timing
    calls (CUDA events), into a plan DB in a temporary directory; the
    candidates, the pruned ones with their reasons and each round's
    scores; the winner's ``.run`` ms beside the analytic seed's, both
    timed here; the tuned program held to the oracle (< 1e-4), its
    launches counted.  Then a second process, ``python -m
    repro_torch.tuning check`` on that DB, must hit for both with zero
    timing calls."""
    import os
    import tempfile

    import torch

    from repro_torch.api import compile_stencil, sweep_schedule
    from repro_torch.core.stencil_spec import get
    from repro_torch.kernels import ref
    from repro_torch.kernels import stencil2d as st
    from repro_torch.kernels import stencil3d as st3
    from repro_torch.stencils.data import init_domain
    from repro_torch.tuning import search

    with tempfile.TemporaryDirectory(prefix="chip_smoke_plandb_") as db:
        for name in TUNE_CASES:
            spec = get(name)
            shape = spec.domain
            wrapper = st.ebisu2d_padded if spec.ndim == 2 \
                else st3.ebisu3d_padded
            t0 = time.perf_counter()
            res = search.tune(spec, shape, db=db, budget=TUNE_BUDGET,
                              device=dev,
                              log=lambda *a: print(*a, flush=True))
            took = time.perf_counter() - t0
            print(f"[tune] {name}: candidates "
                  f"{[c.label() for c in res.candidates]}", flush=True)
            for c, why in res.pruned:
                print(f"[tune] {name}: pruned {c.label()}: {why}",
                      flush=True)
            before = search.TIMING["calls"]
            tuned = compile_stencil(spec, shape, mode="tuned", plan_db=db)
            check(search.TIMING["calls"] == before
                  and tuned.tuned["source"] == "plandb",
                  f"tune {name}: the tuned compile timed or missed")
            seed = compile_stencil(spec, shape)
            steps = res.record["measured"]["total_t"]
            x = init_domain(spec, device=dev, seed=0)
            zero_counts()
            y = tuned.run(x, steps)
            torch.cuda.synchronize()
            launched = wrapper.launches
            sweeps = len(sweep_schedule(steps, tuned.t))
            print(f"[main path] tuned {name} run({steps}) at t={tuned.t} "
                  f"tile {tuned.geometry()['block']}: {wrapper.__name__} "
                  f"launches {launched}", flush=True)
            check(launched == sweeps, f"tune {name}: {launched} launches, "
                  f"want {sweeps}")
            err = held(y, ref.reference(x, spec, steps), 1e-4,
                       f"tuned {name} run({steps}) vs oracle")
            del y
            tuned_ms = median_ms(lambda: tuned.run(x, steps), 5, 1)
            seed_ms = median_ms(lambda: seed.run(x, steps), 5, 1)
            row = dict(stencil=name, domain=list(shape), steps=steps,
                       winner=res.winner.label(),
                       seed=res.seed.label(),
                       seed_was_winner=res.winner == res.seed,
                       candidates=len(res.candidates),
                       pruned=len(res.pruned), rounds=len(res.rounds),
                       timing_calls=res.timing_calls,
                       ratio_to_naive=res.record["measured"][
                           "ratio_to_naive"],
                       naive_us=res.record["measured"]["naive_us"],
                       tuned_run_ms=tuned_ms, seed_run_ms=seed_ms,
                       seed_over_tuned=seed_ms / tuned_ms,
                       launches=launched, max_abs_err=err,
                       tune_s=took)
            print("[timing] tune " + json.dumps(row), flush=True)
            del x
            torch.cuda.empty_cache()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.tuning", "check",
             "--stencil", ",".join(TUNE_CASES), "--scale", "1",
             "--db", db],
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            capture_output=True, text=True, timeout=600)
        for line in proc.stdout.strip().splitlines():
            print(f"[check] second process: {line}", flush=True)
        check(proc.returncode == 0, f"tuning check exited "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
        check(proc.stdout.count("HIT") == len(TUNE_CASES)
              and "timing_calls=0" in proc.stdout,
              "tuning check: a miss or a timing call")


def lm_serve(dev, held) -> dict:
    """The LM serving path, counted: ``launch.serve.run`` serves
    h2o-danube-1.8b at full width with the CUDA flash kernel in every
    prefill layer.  Then, uncounted: the whole path against the chunked
    path (f32, depth cut to 2), the kernel against its plain version at
    the full-width layer shapes and at small ones, and the timing row.
    Returns the ``flash_attention`` entry of the ``kernels`` line."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    import repro_torch.configs as C
    from repro_torch.core.roofline import attention_bound
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import stencil2d as st
    from repro_torch.kernels import stencil3d as st3
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params
    from repro_torch.serve import serve_step

    cfg = C.get_config(LM_ARCH)
    window = cfg.swa_window
    st.ebisu2d_padded.launches = 0
    st3.ebisu3d_padded.launches = 0
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd_dq.launches = 0
    fa.flash_attention_bwd_dkdv.launches = 0
    t0 = time.perf_counter()
    res = serve.run(LM_ARCH, batch=LM_BATCH, prompt_len=LM_PROMPT,
                    max_new=LM_NEW, reduced=False, seed=0,
                    repeats=LM_REPEATS, device=dev,
                    attention_impl="flash_pallas")
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = fa.flash_attention_fwd.launches
    print(f"[main path LM] flash_attention launches: {launches} "
          f"({res.kernel_launches_per_prefill} per prefill, "
          f"{1 + LM_REPEATS} prefills)", flush=True)
    check(st.ebisu2d_padded.launches == 0 and st3.ebisu3d_padded.launches
          == 0, "the LM path launched a stencil kernel")
    check(fa.flash_attention_bwd_dq.launches == 0
          and fa.flash_attention_bwd_dkdv.launches == 0,
          "the LM serving path launched a backward kernel")
    check(res.kernel_launches_per_prefill == cfg.n_layers,
          f"{res.kernel_launches_per_prefill} flash launches per prefill, "
          f"not {cfg.n_layers}")
    check(launches == cfg.n_layers * (1 + LM_REPEATS),
          f"LM path launched the kernel {launches} times, not "
          f"{cfg.n_layers * (1 + LM_REPEATS)}")
    toks = res.tokens
    check(tuple(toks.shape) == (LM_BATCH, LM_NEW), "LM tokens shape")
    check(int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab,
          "LM tokens out of the vocabulary")
    lm = dict(arch=LM_ARCH, n_params=cfg.n_params(), batch=LM_BATCH,
              prompt=LM_PROMPT, new_tokens=LM_NEW, dtype="bfloat16",
              prefill_ms=res.prefill_ms,
              prefill_tok_per_s=LM_BATCH * LM_PROMPT
              / (res.prefill_ms * 1e-3),
              decode_ms_per_step=res.decode_ms / res.decode_steps,
              decode_tok_per_s=res.decode_tok_per_s,
              launches_per_prefill=res.kernel_launches_per_prefill,
              peak_gb=res.peak_bytes / 1e9, host_s_with_init=host_s)
    print("[lm] " + json.dumps(lm), flush=True)
    del res
    torch.cuda.empty_cache()

    # ---- the whole path, f32, depth 2: kernel vs chunked, uncounted ------
    cfg2 = dataclasses.replace(cfg, n_layers=2, activ_dtype=torch.float32,
                               param_dtype=torch.float32)
    model = init_params(transformer.build_model(cfg2, dev),
                        torch.Generator(dev).manual_seed(0))
    prompt = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), device=dev,
                           generator=torch.Generator(dev).manual_seed(1))
    cache_len = LM_PROMPT + LM_NEW + 8
    got = {}
    for impl in ("flash_pallas", "flash_jnp"):
        c = dataclasses.replace(cfg2, attention_impl=impl)
        zero_counts()
        logits, _ = transformer.prefill(c, model, {"tokens": prompt},
                                        cache_len)
        gen = serve_step.greedy_generate(c, model, prompt, 8, cache_len)
        got[impl] = (logits, gen)
        if impl == "flash_pallas":   # the float32 route, counted
            launches_f32 = fa.flash_attention_fwd.launches
    print(f"[main path LM f32] flash_attention launches (the float32 "
          f"route): {launches_f32} (2 prefills of {cfg2.n_layers} layers)",
          flush=True)
    check(launches_f32 == 2 * cfg2.n_layers,
          f"the f32 whole path launched the forward {launches_f32} times, "
          f"not {2 * cfg2.n_layers}")
    check(bool(torch.isfinite(got["flash_pallas"][0]).all()),
          "whole path: non-finite logits")
    whole_err = held(got["flash_pallas"][0], got["flash_jnp"][0],
                     LM_WHOLE_PATH_TOL,
                     "whole path f32 depth 2: last-token logits, kernel vs "
                     "chunked")
    agree = float((got["flash_pallas"][1] == got["flash_jnp"][1])
                  .float().mean())
    print(f"[check] whole path f32 depth 2: greedy tokens agree "
          f"{agree:.4f} of {got['flash_jnp'][1].numel()}", flush=True)
    del model, got, logits, gen
    torch.cuda.empty_cache()

    # ---- the kernel against its plain version, uncounted -----------------
    h, kv, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    gen = torch.Generator(dev).manual_seed(2)

    def qkv(b, s, h, kv, hd, dtype, sk=None):
        sk = s if sk is None else sk
        return [torch.randn(shape, generator=gen, device=dev).to(dtype)
                for shape in ((b, s, h, hd), (b, sk, kv, hd),
                              (b, sk, kv, hd))]

    def held_out(got, want, dtype, what):
        if dtype == torch.float32:
            return held(got, want, 2e-5, what), None
        return held_bf16(got, want, what)

    errs, shares = {}, {}
    shape = f"B{LM_BATCH} S{LM_PROMPT} H{h} KV{kv} hd{hd} window {window}"
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = qkv(LM_BATCH, LM_PROMPT, h, kv, hd, dtype)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=True,
                                          window=window)
        alone = fa.flash_attention(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        want, want_lse = fa.flash_attention_fwd_plain(q, k, v, causal=True,
                                                      window=window)
        name = str(dtype).removeprefix("torch.")
        errs[name], shares[name] = held_out(
            out, want, dtype, f"flash {name} {shape}: out (lse on) vs plain")
        held_out(alone, want, dtype,
                 f"flash {name} {shape}: out (lse off) vs plain")
        check(torch.equal(alone, out), f"flash {name}: lse on and off "
              "differ")
        if dtype == torch.float32:
            errs["lse"] = held(lse, want_lse, 1e-4,
                               f"flash {name} {shape}: lse vs plain")
        else:   # the backward reads this lse; no atomics: repeats exactly
            errs["lse_bf16"] = held(lse, want_lse, 1e-4,
                                    f"flash {name} {shape}: lse vs plain")
            again, again_lse = fa.flash_attention_fwd(q, k, v, causal=True,
                                                      window=window)
            torch.cuda.synchronize()
            check(torch.equal(again, out) and torch.equal(again_lse, lse),
                  f"flash {name} {shape}: a second launch differs")
            print(f"[check] flash {name} {shape}: a second launch agrees bit "
                  f"for bit (out and lse)", flush=True)
            del again, again_lse
        del q, k, v, out, lse, alone, want, want_lse
    # the bf16 limit's power: one key dropped from each full window fails it
    q, k, v = qkv(LM_BATCH, LM_PROMPT, h, kv, hd, torch.bfloat16)
    want, _ = fa.flash_attention_fwd_plain(q, k, v, causal=True,
                                           window=window)
    dropped, _ = fa.flash_attention_fwd_plain(q, k, v, causal=True,
                                              window=window - 1)
    gap = (dropped.double() - want.double()).abs()
    control = dict(max_abs_err=float(gap.max()), share=float(
        (gap / (BF16_ATOL + BF16_RTOL * want.double().abs())).max()))
    print(f"[check] bf16 limit control, window {window - 1} against "
          f"{window}: max|err| {control['max_abs_err']:.3e}, "
          f"{control['share']:.2f} of the limit (must exceed 1)", flush=True)
    check(control["share"] > 1.0, "the bf16 limit passes one key dropped")
    del q, k, v, want, dropped, gap
    # the last five: the bf16 kernel's tile edges (a window of 64 on the
    # 64-row edge, hd 96, hd 144's 32-key tiles, a window of 47 on a warp's
    # 16-row edge) and rows that keep no key
    for b, s, hh, kk, d, causal, win, sk in [
            (2, 320, 4, 4, 64, True, None, None),
            (2, 320, 8, 2, 128, False, None, None),
            (1, 256, 4, 1, 256, True, 100, None),
            (2, 300, 8, 8, 80, False, 64, None),
            (2, 256, 8, 2, 80, True, 64, None),
            (1, 200, 4, 1, 96, True, 33, None),
            (1, 160, 4, 2, 144, False, 32, None),
            (1, 200, 4, 1, 80, True, 47, None),
            (2, 150, 4, 1, 80, True, 30, 40)]:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = qkv(b, s, hh, kk, d, dtype, sk)
            out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                              window=win)
            want, want_lse = fa.flash_attention_fwd_plain(
                q, k, v, causal=causal, window=win)
            what = (f"flash {str(dtype).removeprefix('torch.')} B{b} S{s} "
                    f"Sk{k.shape[1]} H{hh} KV{kk} hd{d} causal={causal} "
                    f"window={win}")
            held_out(out, want, dtype, what + ": out vs plain")
            held(lse, want_lse, 1e-4, what + ": lse vs plain")

    # ---- timing at the full-width layer shapes, bf16, uncounted ----------
    q, k, v = qkv(LM_BATCH, LM_PROMPT, h, kv, hd, torch.bfloat16)
    kern_ms = median_ms(lambda: fa.flash_attention_fwd(
        q, k, v, causal=True, window=window), 10, 2)
    lse_off_ms = median_ms(lambda: fa.flash_attention(
        q, k, v, causal=True, window=window), 10, 2)
    plain_ms = median_ms(lambda: fa.flash_attention_fwd_plain(
        q, k, v, causal=True, window=window), 3, 1)
    pos = torch.arange(LM_PROMPT, device=dev)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :]
                                             > pos[:, None] - window)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)

    lib_ms = median_ms(library, 5, 1)
    held(library().transpose(1, 2), fa.flash_attention(
        q, k, v, causal=True, window=window), 0.06,
        "scaled_dot_product_attention yardstick vs kernel (bf16)")
    bound = attention_bound(LM_BATCH, LM_PROMPT, LM_PROMPT, h, kv, hd,
                            causal=True, window=window, bytes_per_el=2)
    # what the tile model and the build say of the kernel (not measured)
    issued = LM_BATCH * fa.fwd_issued_flops(LM_PROMPT, LM_PROMPT, h, kv, hd,
                                            causal=True, window=window)
    usage = _build.ptxas_usage(_build.build_log("flash_attention_mma"))
    model = dict(tiles=list(fa.fwd_tiles(hd)), issued_flops=issued,
                 issued_flops_per_kept_pair=issued
                 / (bound["pairs_per_head"] * h * LM_BATCH),
                 smem_bytes=fa.smem_bytes(hd),
                 registers_spill_stores={n: u for n, u in usage.items()
                                         if f"ILi{hd}E" in n},
                 # the modelled flop count over the measured ms
                 modelled_issued_tflop_per_s_at_ms=issued
                 / (kern_ms * 1e-3) / 1e12)
    print(f"[model] flash fwd bfloat16 kernel at hd {hd}: "
          f"{json.dumps(model)}", flush=True)
    row = dict(shape=[LM_BATCH, LM_PROMPT, h, kv, hd], window=window,
               dtype="bfloat16", ms=kern_ms, ms_lse_off=lse_off_ms,
               plain_ms=plain_ms,
               library_ms=lib_ms, **bound,
               roofline_share=bound["bound_ms"] / kern_ms,
               tflop_per_s=bound["flops"] / (kern_ms * 1e-3) / 1e12,
               launches=launches)
    print("[timing] " + json.dumps(row), flush=True)
    del q, k, v, qt, kt, vt
    f32 = f32_fwd_timing(dev, shape, (LM_BATCH, LM_PROMPT, h, kv, hd),
                         window, launches_f32, errs)
    f32.update(max_abs_err_whole_path_f32=whole_err,
               greedy_agreement_whole_path=agree)
    return [{
        "name": "flash_attention", "route": "cuda", "source": SOURCE_FA,
        "replaces": REPLACES_FA, "launches": launches,
        "max_abs_err": errs["bfloat16"],
        "ms": kern_ms, "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"], "library_ms": lib_ms,
        "times_are": "one forward call at h2o-danube-1.8b's prefill layer "
                     "shapes (B4 S8192 H32 KV8 hd80, causal, window 4096), "
                     "bf16, with the lse (the instantiation the path "
                     "launches), on the tensor-core kernel; ms_lse_off is "
                     "the lse-off instantiation; library_ms is "
                     "scaled_dot_product_attention with the same boolean "
                     "mask",
        "ms_lse_off": lse_off_ms,
        "bf16_share_of_limit": shares["bfloat16"],
        "bf16_limit": [BF16_ATOL, BF16_RTOL],
        "bf16_limit_control_window_minus_1": control,
        "max_abs_err_lse_bf16": errs["lse_bf16"], "lm": lm, "timing": row},
        f32]


def f32_fwd_timing(dev, shape, dims, window, launches, errs) -> dict:
    """The float32 forward kernel timed at the full-width layer shape
    ``dims`` = (B, S, H, KV, hd): with and without the lse, beside its
    plain version, its bound at the dense TF32 tensor peak and one
    ``scaled_dot_product_attention`` call in float32 with
    ``torch.backends.cuda.matmul.allow_tf32 = False``; returns the
    ``flash_attention_f32`` entry of the ``kernels`` line (``launches``:
    the counted f32 whole path's)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.roofline import (H100_TF32_TENSOR_FLOPS,
                                           attention_bound)
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    b, s, h, kv, hd = dims
    gen = torch.Generator(dev).manual_seed(4)
    q, k, v = (torch.randn(x, generator=gen, device=dev)
               for x in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
    kern_ms = median_ms(lambda: fa.flash_attention_fwd(
        q, k, v, causal=True, window=window), 10, 2)
    lse_off_ms = median_ms(lambda: fa.flash_attention(
        q, k, v, causal=True, window=window), 10, 2)
    plain_ms = median_ms(lambda: fa.flash_attention_fwd_plain(
        q, k, v, causal=True, window=window), 3, 1)
    pos = torch.arange(s, device=dev)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :]
                                             > pos[:, None] - window)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False   # a float32 yardstick
    try:
        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)

        lib_ms = median_ms(library, 5, 1)
        backend = sdpa_backend(library)
        yard = held(library().transpose(1, 2), fa.flash_attention(
            q, k, v, causal=True, window=window), 1e-3,
            "scaled_dot_product_attention yardstick vs kernel (f32)")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    print(f"[timing] scaled_dot_product_attention f32 forward: "
          f"{json.dumps(backend)}", flush=True)
    bound = attention_bound(b, s, s, h, kv, hd, causal=True, window=window,
                            bytes_per_el=4,
                            flops_per_s=H100_TF32_TENSOR_FLOPS)
    # what the tile model and the build say of the kernel (not measured)
    issued = b * fa.fwd_issued_flops(s, s, h, kv, hd, causal=True,
                                     window=window, dtype=torch.float32)
    usage = _build.ptxas_usage(_build.build_log("flash_attention_tf32"))
    model = dict(tiles=list(fa.fwd_tiles(hd, torch.float32)),
                 issued_flops=issued, issued_flops_per_kept_pair=issued
                 / (bound["pairs_per_head"] * h * b),
                 smem_bytes=fa.smem_bytes(hd, torch.float32),
                 registers_spill_stores={n: u for n, u in usage.items()
                                         if f"ILi{fa.hd_bound(hd)}E" in n},
                 # the modelled flop count over the measured ms
                 modelled_issued_tflop_per_s_at_ms=issued
                 / (kern_ms * 1e-3) / 1e12)
    print(f"[model] flash fwd float32 kernel at hd {hd}: "
          f"{json.dumps(model)}", flush=True)
    row = dict(shape=list(dims), window=window, dtype="float32",
               ms=kern_ms, ms_lse_off=lse_off_ms, plain_ms=plain_ms,
               library_ms=lib_ms, sdpa_allow_tf32=False,
               sdpa_forward=backend, sdpa_vs_kernel_max_abs_err=yard,
               **bound, roofline_share=bound["bound_ms"] / kern_ms,
               tflop_per_s=bound["flops"] / (kern_ms * 1e-3) / 1e12,
               launches=launches)
    print("[timing] " + json.dumps(row), flush=True)
    return {
        "name": "flash_attention_f32", "route": "cuda",
        "source": SOURCE_FA_F32, "replaces": REPLACES_FA,
        "launches": launches,
        "max_abs_err": errs["float32"], "max_abs_err_lse": errs["lse"],
        "limits": {"out": 2e-5, "lse": 1e-4},
        "ms": kern_ms, "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"], "library_ms": lib_ms,
        "times_are": f"one forward call at {shape}, float32, with the lse; "
                     "ms_lse_off is the lse-off instantiation; the bound "
                     "at the dense TF32 tensor peak (495 TFLOP/s); "
                     "library_ms is scaled_dot_product_attention in "
                     "float32 with the same boolean mask and "
                     "allow_tf32 = False; launches are the counted f32 "
                     "whole path's",
        "ms_lse_off": lse_off_ms, "timing": row}


def device_kernels(run) -> tuple:
    """``run()`` once under ``torch.profiler``: its host-clock ms, and the
    CUDA kernels it ran as ``(ms, calls, name)``, longest first, or a
    "not measured (...)" string where the profiler gave no device time.
    Only the profiler is guarded: what ``run`` raises propagates."""
    import torch

    prof, note = None, "not measured (no device time in the trace)"
    try:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    except Exception as e:   # the profiler is a diagnostic only
        prof, note = None, f"not measured (torch.profiler: {e})"
    t0 = time.perf_counter()
    try:
        run()
        torch.cuda.synchronize()
    finally:
        wall_ms = (time.perf_counter() - t0) * 1e3
        if prof is not None:
            try:
                prof.stop()
            except Exception as e:
                prof, note = None, f"not measured (torch.profiler: {e})"
    evs = []
    try:
        for e in (prof.key_averages() if prof is not None else ()):
            t = getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0))
            if t > 0:
                evs.append((t / 1e3, e.count, e.key))
    except Exception as e:
        evs, note = [], f"not measured (torch.profiler: {e})"
    return wall_ms, sorted(evs, reverse=True) or note


def sdpa_backend(run) -> dict:
    """Which ``scaled_dot_product_attention`` backend ``run`` (a forward
    and backward) takes: the backends that accept it when it is limited
    to each in turn, and the CUDA kernels ``torch.profiler`` saw in one
    default call, longest first."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    accepts = []
    for b in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
              SDPBackend.EFFICIENT_ATTENTION):
        try:    # a backend that cannot take the call raises: that is the probe
            with sdpa_kernel([b]), warnings.catch_warnings():
                warnings.simplefilter("ignore")     # each refusal's reasons
                run()
            torch.cuda.synchronize()
            accepts.append(b.name)
        except RuntimeError:
            pass
    _, evs = device_kernels(run)
    kernels = ([evs] if isinstance(evs, str) else
               [f"{k[:100]} ({t:.3f} ms)" for t, _, k in evs[:4]])
    return {"accepting_backends": accepts, "kernels": kernels}


def lm_train(dev) -> dict:
    """The training path, counted: ``launch.train.train`` trains
    h2o-danube-1.8b at full width with the flash forward kernel (twice
    per layer and microbatch, remat) and both backward kernels (once).
    Then, uncounted: the whole training path in f32 against the chunked
    path (depth cut to 2), the backward kernels against their plain
    version at the full-width layer shape and at small ones, and the
    timing row.  Returns the ``flash_attention_bwd`` entry of the
    ``kernels`` line."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    import repro_torch.configs as C
    from repro_torch.core.roofline import attention_bwd_bound
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import stencil2d as st
    from repro_torch.kernels import stencil3d as st3
    from repro_torch.launch import train as trainer
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params
    from repro_torch.train import optimizer as opt
    from repro_torch.train.data import batch_for_step
    from repro_torch.train.train_step import loss_fn, make_train_step

    cfg = C.get_config(TRAIN_ARCH)
    window, n_micro = cfg.swa_window, cfg.microbatches
    st.ebisu2d_padded.launches = 0
    st3.ebisu3d_padded.launches = 0
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd_dq.launches = 0
    fa.flash_attention_bwd_dkdv.launches = 0
    t0 = time.perf_counter()
    params, state, losses = trainer.train(
        TRAIN_ARCH, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        reduced=False, device=dev, attention_impl="flash_pallas",
        log_every=1)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    stats = trainer.train.last_stats
    fwd = fa.flash_attention_fwd.launches
    dq_n = fa.flash_attention_bwd_dq.launches
    dkdv_n = fa.flash_attention_bwd_dkdv.launches
    print(f"[main path train] flash launches: forward {fwd}, backward dQ "
          f"{dq_n}, dK/dV {dkdv_n}", flush=True)
    check(st.ebisu2d_padded.launches == 0 and st3.ebisu3d_padded.launches
          == 0, "the training path launched a stencil kernel")
    per = cfg.n_layers * n_micro * TRAIN_STEPS
    check(fwd == 2 * per, f"forward kernel launched {fwd} times, not "
          f"{2 * per} (layers × microbatches × steps × 2)")
    check(dq_n == per and dkdv_n == per, f"backward kernels launched "
          f"{dq_n} and {dkdv_n} times, not {per}")
    check(len(losses) == TRAIN_STEPS and all(
        math.isfinite(x) for x in losses + stats.grad_norms),
        f"training losses {losses}, grad norms {stats.grad_norms}")
    print(f"[check] train: losses {losses}, grad norms "
          f"{stats.grad_norms}: finite", flush=True)
    train = dict(arch=TRAIN_ARCH, n_params=cfg.n_params(), steps=TRAIN_STEPS,
                 batch=TRAIN_BATCH, seq=TRAIN_SEQ, microbatches=n_micro,
                 remat=cfg.remat, dtype="bfloat16", losses=losses,
                 grad_norms=stats.grad_norms, step_ms=stats.step_ms,
                 timed_steps=stats.timed_steps,
                 tokens_per_s=stats.tokens_per_s,
                 peak_gb=stats.peak_bytes / 1e9, host_s_with_init=host_s,
                 launches_fwd=fwd, launches_dq=dq_n, launches_dkdv=dkdv_n)
    print("[train] " + json.dumps(train), flush=True)
    del params, state
    torch.cuda.empty_cache()

    # ---- the whole path, f32, depth 2: kernels vs chunked, uncounted ----
    cfg2 = dataclasses.replace(cfg, n_layers=2, activ_dtype=torch.float32,
                               param_dtype=torch.float32)
    model = init_params(transformer.build_model(cfg2, dev),
                        torch.Generator(dev).manual_seed(0))
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    shapes = {"tokens": (TRAIN_BATCH, TRAIN_SEQ),
              "labels": (TRAIN_BATCH, TRAIN_SEQ)}
    batch = batch_for_step(cfg2, "train_4k", 0, seed=1, reduced_shapes=shapes,
                           device=dev)
    micro = {k: v[:TRAIN_BATCH // n_micro] for k, v in batch.items()}
    got = {}
    for impl in ("flash_pallas", "flash_jnp"):
        c = dataclasses.replace(cfg2, attention_impl=impl)
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(init[n])
        zero_counts()
        loss = loss_fn(c, model, micro)
        names, leaves = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, leaves)
        ocfg = opt.OptConfig(lr=TRAIN_CHECK_LR, warmup=1, total_steps=1,
                             schedule=c.schedule)
        ostate = opt.init_state(model)
        make_train_step(c, ocfg)(model, ostate, batch)
        if impl == "flash_pallas":   # the float32 route, counted
            launches_f32 = (fa.flash_attention_fwd.launches,
                            fa.flash_attention_bwd_dq.launches,
                            fa.flash_attention_bwd_dkdv.launches)
        got[impl] = dict(loss=float(loss.detach()), grads=dict(zip(names,
                                                                   grads)),
                         params={n: p.detach().clone()
                                 for n, p in model.named_parameters()})
        del ostate, loss, grads
        torch.cuda.empty_cache()
    # a loss and its gradients, then a step of n_micro microbatches: each
    # layer's forward twice (remat) and each backward kernel once a pass
    passes = (1 + n_micro) * cfg2.n_layers
    print(f"[main path train f32] flash launches (the float32 route): "
          f"forward {launches_f32[0]}, dQ {launches_f32[1]}, dK/dV "
          f"{launches_f32[2]}", flush=True)
    check(launches_f32 == (2 * passes, passes, passes),
          f"the f32 whole training path launched {launches_f32}, not "
          f"{(2 * passes, passes, passes)}")
    k_, c_ = got["flash_pallas"], got["flash_jnp"]
    loss_err = abs(k_["loss"] - c_["loss"])
    check(math.isfinite(k_["loss"]) and loss_err < TRAIN_LOSS_TOL,
          f"whole training path f32 depth 2: loss {k_['loss']} vs "
          f"{c_['loss']}")
    print(f"[check] whole training path f32 depth 2: loss {k_['loss']:.6f}, "
          f"kernels vs chunked |err| {loss_err:.3e} (< {TRAIN_LOSS_TOL:g})",
          flush=True)
    grad_share = 0.0
    for n, g in k_["grads"].items():
        want = c_["grads"][n]
        check(bool(torch.isfinite(g).all()), f"grad {n}: non-finite")
        lim = TRAIN_GRAD_TOL * float(want.abs().max())
        err = float((g.double() - want.double()).abs().max())
        check(err <= lim, f"grad {n}: max|err| {err:.3e} > {lim:.3e}")
        grad_share = max(grad_share, err / lim if lim else 0.0)
    print(f"[check] whole training path f32 depth 2: every gradient leaf "
          f"within {TRAIN_GRAD_TOL:g} of its largest |value| (at most "
          f"{grad_share:.4f} of that limit)", flush=True)
    param_err = 0.0
    for n, p in k_["params"].items():
        check(bool(torch.isfinite(p).all()), f"param {n}: non-finite")
        param_err = max(param_err,
                        float((p - c_["params"][n]).abs().max()))
    check(param_err < TRAIN_PARAM_TOL, f"params after one AdamW step: "
          f"max|err| {param_err:.3e} >= {TRAIN_PARAM_TOL:g}")
    moved = float((k_["params"]["head"] - init["head"]).abs().median())
    check(moved > 0.5 * TRAIN_CHECK_LR, f"the step moved the head by a "
          f"median {moved:.3e} only")
    print(f"[check] whole training path f32 depth 2: every parameter after "
          f"the step within {TRAIN_PARAM_TOL:g} (max|err| {param_err:.3e}); "
          f"the head moved by a median {moved:.3e}", flush=True)
    whole = dict(loss=k_["loss"], loss_err=loss_err,
                 grad_share_of_limit=grad_share, param_err=param_err,
                 head_median_step=moved)
    del model, init, got, k_, c_, batch, micro
    torch.cuda.empty_cache()

    # ---- the backward kernels against their plain version, uncounted ----
    h, kv, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    gen = torch.Generator(dev).manual_seed(3)

    def inputs(b, s, h, kv, hd, dtype, causal, win):
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                       .to(dtype) for shape in ((b, s, h, hd), (b, s, kv, hd),
                                                (b, s, kv, hd), (b, s, h, hd)))
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=win)
        return q, k, v, do, out, lse

    shape = f"B1 S{TRAIN_SEQ} H{h} KV{kv} hd{hd} window {window}"
    errs, shares = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        args = inputs(1, TRAIN_SEQ, h, kv, hd, dtype, True, window)
        errs[name], shares[name] = bwd_vs_plain(
            args, True, window, dtype, f"flash bwd {name} {shape}")
        if dtype == torch.bfloat16:
            first = fa.flash_attention_bwd(*args, causal=True, window=window)
            again = fa.flash_attention_bwd(*args, causal=True, window=window)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(first, again)),
                  f"flash bwd {name} {shape}: a second launch differs")
            print(f"[check] flash bwd {name} {shape}: a second launch "
                  f"agrees bit for bit", flush=True)
            del first, again
        del args
    # the bf16 limit's power: the gradient of the window - 1 attention
    args = inputs(1, TRAIN_SEQ, h, kv, hd, torch.bfloat16, True, window)
    control = bwd_window_control(args, window, shape)
    del args
    for b, s, hh, kk, d, causal, win in [(2, 200, 4, 4, 64, True, None),
                                        (2, 200, 8, 2, 128, False, None),
                                        (1, 256, 8, 1, 256, True, 100),
                                        (2, 300, 8, 8, 80, False, 64),
                                        (1, 130, 4, 1, 16, True, 24),
                                        (2, 230, 4, 2, 80, True, 64),
                                        (1, 190, 8, 2, 256, False, None)]:
        for dtype in (torch.float32, torch.bfloat16):
            bwd_vs_plain(inputs(b, s, hh, kk, d, dtype, causal, win), causal,
                         win, dtype, f"flash bwd "
                         f"{str(dtype).removeprefix('torch.')} B{b} S{s} "
                         f"H{hh} KV{kk} hd{d} causal={causal} window={win}")

    # ---- timing at the training layer shape, bf16, uncounted ------------
    q, k, v, do, out, lse = inputs(1, TRAIN_SEQ, h, kv, hd, torch.bfloat16,
                                   True, window)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    fwd_ms = median_ms(lambda: fa.flash_attention_fwd(
        q, k, v, causal=True, window=window), 10, 2)
    kern_ms = median_ms(lambda: fa.flash_attention_bwd(
        q, k, v, do, out, lse, causal=True, window=window), 10, 2)
    dq_ms = median_ms(lambda: fa.flash_attention_bwd_dq(
        q, k, v, do, lse, delta, dq, causal=True, window=window), 10, 2)
    dkdv_ms = median_ms(lambda: fa.flash_attention_bwd_dkdv(
        q, k, v, do, lse, delta, dk, dv, causal=True, window=window), 10, 2)
    plain_ms = median_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, do, out, lse, causal=True, window=window), 3, 1)
    pos = torch.arange(TRAIN_SEQ, device=dev)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :]
                                             > pos[:, None] - window)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)

    backend = sdpa_backend(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt),
                                                       dot))
    print(f"[timing] scaled_dot_product_attention backward: "
          f"{json.dumps(backend)}", flush=True)
    out_t = sdpa()
    lib_ms = median_ms(lambda: torch.autograd.grad(
        out_t, (qt, kt, vt), dot, retain_graph=True), 5, 1)
    lib = torch.autograd.grad(out_t, (qt, kt, vt), dot)
    mine = fa.flash_attention_bwd(q, k, v, do, out, lse, causal=True,
                                  window=window)
    yard = {}
    for name, a, b in zip(("dq", "dk", "dv"), mine, lib):
        yard[name] = float((a.double() - b.transpose(1, 2).double()).abs()
                           .max() / b.double().abs().max())
    print(f"[check] SDPA backward yardstick vs kernels (bf16): max|err| / "
          f"max|value| {json.dumps(yard)} (< 0.02)", flush=True)
    check(all(x < 0.02 for x in yard.values()),
          "the SDPA backward yardstick disagrees with the kernels")
    bound = attention_bwd_bound(1, TRAIN_SEQ, TRAIN_SEQ, h, kv, hd,
                                causal=True, window=window, bytes_per_el=2)
    # what the tile model and the build say of the kernels (not measured)
    issued = fa.bwd_issued_flops(TRAIN_SEQ, TRAIN_SEQ, h, kv, hd,
                                 causal=True, window=window)
    usage = _build.ptxas_usage(_build.build_log("flash_attention_bwd_mma"))
    model = dict(tiles=fa.bwd_tiles(hd), issued_flops=issued,
                 issued_flops_per_kept_pair=issued
                 / (bound["pairs_per_head"] * h),
                 smem_bytes=[fa.bwd_smem_bytes(0, hd),
                             fa.bwd_smem_bytes(1, hd)],
                 registers_spill_stores={n: u for n, u in usage.items()
                                         if f"ILi{hd}E" in n})
    print("[model] flash bwd bfloat16 kernels at hd "
          f"{hd}: {json.dumps(model)}", flush=True)
    attn_ms = 2 * cfg.n_layers * n_micro * fwd_ms \
        + cfg.n_layers * n_micro * kern_ms
    row = dict(shape=[1, TRAIN_SEQ, h, kv, hd], window=window,
               dtype="bfloat16", ms=kern_ms, dq_ms=dq_ms, dkdv_ms=dkdv_ms,
               plain_ms=plain_ms, library_ms=lib_ms, **bound,
               roofline_share=bound["bound_ms"] / kern_ms,
               tflop_per_s=bound["flops"] / (kern_ms * 1e-3) / 1e12,
               fwd_ms_at_train_shape=fwd_ms,
               flash_ms_per_step=attn_ms,
               flash_share_of_step=attn_ms / stats.step_ms,
               sdpa_backward=backend)
    print("[timing] " + json.dumps(row), flush=True)
    del q, k, v, do, out, lse, qt, kt, vt, dot, out_t, lib, mine
    f32 = f32_bwd_timing(dev, shape, (1, TRAIN_SEQ, h, kv, hd), window,
                         launches_f32, errs["float32"])
    f32["whole_training_path_f32"] = whole
    return [{
        "name": "flash_attention_bwd", "route": "cuda",
        "source": SOURCE_FA_BWD, "replaces": REPLACES_FA_BWD,
        "launches": dkdv_n, "launches_dq": dq_n, "launches_dkdv": dkdv_n,
        "max_abs_err": errs["bfloat16"],
        "ms": kern_ms, "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"], "library_ms": lib_ms,
        "times_are": "one backward call (delta, the dQ kernel and the dK/dV "
                     "kernel) at h2o-danube-1.8b's training layer shape (B1 "
                     "S8192 H32 KV8 hd80, causal, window 4096), bf16, on "
                     "the tensor-core kernels; library_ms is "
                     "torch.autograd.grad through "
                     "scaled_dot_product_attention with the same boolean "
                     "mask",
        "dq_ms": dq_ms, "dkdv_ms": dkdv_ms,
        "bf16_share_of_limit": shares["bfloat16"],
        "bf16_limit_control_window_minus_1": control,
        "train": train, "timing": row},
        f32]


def f32_bwd_timing(dev, shape, dims, window, launches, err) -> dict:
    """The float32 backward kernels timed at the training layer shape
    ``dims`` = (B, S, H, KV, hd), the call and dQ and dK/dV apart, beside
    the plain version, the bound at the dense TF32 tensor peak and
    ``scaled_dot_product_attention``'s backward in float32 with
    ``torch.backends.cuda.matmul.allow_tf32 = False``; returns the
    ``flash_attention_bwd_f32`` entry of the ``kernels`` line
    (``launches``: the counted f32 whole training path's (forward, dQ,
    dK/dV))."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.roofline import (H100_TF32_TENSOR_FLOPS,
                                           attention_bwd_bound)
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    b, s, h, kv, hd = dims
    gen = torch.Generator(dev).manual_seed(5)
    q, k, v, do = (torch.randn(x, generator=gen, device=dev)
                   for x in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd),
                             (b, s, h, hd)))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True, window=window)
    delta = (do * out).sum(-1).permute(0, 2, 1).contiguous()
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    kern_ms = median_ms(lambda: fa.flash_attention_bwd(
        q, k, v, do, out, lse, causal=True, window=window), 10, 2)
    dq_ms = median_ms(lambda: fa.flash_attention_bwd_dq(
        q, k, v, do, lse, delta, dq, causal=True, window=window), 10, 2)
    dkdv_ms = median_ms(lambda: fa.flash_attention_bwd_dkdv(
        q, k, v, do, lse, delta, dk, dv, causal=True, window=window), 10, 2)
    plain_ms = median_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, do, out, lse, causal=True, window=window), 3, 1)
    pos = torch.arange(s, device=dev)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :]
                                             > pos[:, None] - window)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False   # a float32 yardstick
    try:
        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)

        backend = sdpa_backend(lambda: torch.autograd.grad(
            sdpa(), (qt, kt, vt), dot))
        out_t = sdpa()
        lib_ms = median_ms(lambda: torch.autograd.grad(
            out_t, (qt, kt, vt), dot, retain_graph=True), 5, 1)
        lib = torch.autograd.grad(out_t, (qt, kt, vt), dot)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    print(f"[timing] scaled_dot_product_attention f32 backward: "
          f"{json.dumps(backend)}", flush=True)
    mine = fa.flash_attention_bwd(q, k, v, do, out, lse, causal=True,
                                  window=window)
    yard = {}
    for name, a, want in zip(("dq", "dk", "dv"), mine, lib):
        yard[name] = held(a, want.transpose(1, 2), 1e-3,
                          f"SDPA f32 backward yardstick vs kernels: {name}")
    # how far the kernels and the float32 plain version each are from the
    # plain version run in float64 on the same out and lse
    del lib, out_t
    plain = fa.flash_attention_bwd_plain(q, k, v, do, out, lse, causal=True,
                                         window=window)
    exact = fa.flash_attention_bwd_plain(
        *(x.double() for x in (q, k, v, do, out, lse)), causal=True,
        window=window)
    f64 = {"kernels": {}, "plain": {}}
    for name, a, p, want in zip(("dq", "dk", "dv"), mine, plain, exact):
        f64["kernels"][name] = held(
            a, want, 1e-4, f"flash bwd float32 {shape}: {name} vs the "
            "plain version in float64")
        f64["plain"][name] = float((p.double() - want).abs().max())
    print(f"[check] flash bwd float32 {shape}: the float32 plain version "
          f"vs itself in float64: {json.dumps(f64['plain'])}", flush=True)
    del plain, exact
    bound = attention_bwd_bound(b, s, s, h, kv, hd, causal=True,
                                window=window, bytes_per_el=4,
                                flops_per_s=H100_TF32_TENSOR_FLOPS)
    # what the tile model and the build say of the kernels (not measured)
    issued = b * fa.bwd_issued_flops(s, s, h, kv, hd, causal=True,
                                     window=window, dtype=torch.float32)
    usage = _build.ptxas_usage(_build.build_log("flash_attention_bwd_tf32"))
    model = dict(tiles=fa.bwd_tiles(hd, torch.float32), issued_flops=issued,
                 issued_flops_per_kept_pair=issued
                 / (bound["pairs_per_head"] * h * b),
                 smem_bytes=[fa.bwd_smem_bytes(0, hd, torch.float32),
                             fa.bwd_smem_bytes(1, hd, torch.float32)],
                 registers_spill_stores={n: u for n, u in usage.items()
                                         if f"ILi{fa.hd_bound(hd)}E" in n},
                 modelled_issued_tflop_per_s_at_ms=issued
                 / (kern_ms * 1e-3) / 1e12)
    print(f"[model] flash bwd float32 kernels at hd {hd}: "
          f"{json.dumps(model)}", flush=True)
    row = dict(shape=list(dims), window=window, dtype="float32",
               ms=kern_ms, dq_ms=dq_ms, dkdv_ms=dkdv_ms, plain_ms=plain_ms,
               library_ms=lib_ms, sdpa_allow_tf32=False,
               sdpa_backward=backend, sdpa_vs_kernels_max_abs_err=yard,
               max_abs_err_vs_float64=f64,
               **bound, roofline_share=bound["bound_ms"] / kern_ms,
               tflop_per_s=bound["flops"] / (kern_ms * 1e-3) / 1e12,
               launches_fwd_dq_dkdv=list(launches))
    print("[timing] " + json.dumps(row), flush=True)
    return {
        "name": "flash_attention_bwd_f32", "route": "cuda",
        "source": SOURCE_FA_BWD_F32, "replaces": REPLACES_FA_BWD,
        "launches": launches[2], "launches_dq": launches[1],
        "launches_dkdv": launches[2], "max_abs_err": err, "limit": 1e-4,
        "ms": kern_ms, "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"], "library_ms": lib_ms,
        "times_are": f"one backward call (delta, dQ and dK/dV) at {shape}, "
                     "float32; dq_ms and dkdv_ms the kernels alone; the "
                     "bound at the dense TF32 tensor peak (495 TFLOP/s); "
                     "library_ms is torch.autograd.grad through "
                     "scaled_dot_product_attention in float32 with the "
                     "same boolean mask and allow_tf32 = False; launches "
                     "are the counted f32 whole training path's",
        "dq_ms": dq_ms, "dkdv_ms": dkdv_ms, "timing": row}


def family_batch(cfg, batch, seq, gen, dev):
    """A prompt of ``seq`` positions for ``cfg``'s family, from ``gen``:
    frames and a 15 % mask for the encoder; tokens for the decoders, the
    VLM's after its patches (``seq`` counts both)."""
    import torch

    if cfg.family == "encoder":
        return {"frames": torch.randn((batch, seq, cfg.d_model),
                                      generator=gen, device=dev)
                .to(cfg.activ_dtype),
                "mask": torch.rand((batch, seq), generator=gen,
                                   device=dev) < 0.15}
    patches = cfg.vlm_patches if cfg.family == "vlm" else 0
    out = {"tokens": torch.randint(0, cfg.vocab, (batch, seq - patches),
                                   generator=gen, device=dev)}
    if patches:
        out["patches"] = torch.randn(
            (batch, patches, cfg.vlm_patch_dim), generator=gen,
            device=dev).to(cfg.activ_dtype)
    return out


def attention_calls(cfg) -> int:
    """Attention calls in one forward of ``cfg``: none for the SSM, one
    per shared invocation for the hybrid, one per layer otherwise."""
    from repro_torch.models import transformer

    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return transformer.n_shared_invocations(cfg)
    return cfg.n_layers


def profiled(fn) -> dict:
    """``fn()`` once under ``torch.profiler``: its host-clock ms, the CUDA
    kernels' summed time and its share of that ms (the device's busy
    share), and the six kernels that took longest, with their calls."""
    wall_ms, evs = device_kernels(fn)
    if isinstance(evs, str):
        return {"profile": evs}
    busy = sum(t for t, _, _ in evs)
    return dict(host_ms_profiled=wall_ms, kernel_ms=busy,
                device_busy_share=busy / wall_ms,
                top_kernels=[f"{k[:90]} x{n}: {t:.3f} ms"
                             for t, n, k in evs[:6]])


def family_profiles(cfg, batch, seq, dev) -> dict:
    """A prefill of ``cfg`` (random weights, after a warm-up) and, for a
    decoder, one decode step after it, each :func:`profiled`."""
    import torch

    from repro_torch.models import transformer
    from repro_torch.models.params import init_params

    model = init_params(transformer.build_model(cfg, dev),
                        torch.Generator(dev).manual_seed(0))
    prompt = family_batch(cfg, batch, seq, torch.Generator(dev).manual_seed(1),
                          dev)
    out = {}
    logits, cache = transformer.prefill(cfg, model, prompt, seq + 8)
    out["prefill"] = profiled(
        lambda: transformer.prefill(cfg, model, prompt, seq + 8))
    if cfg.family != "encoder":
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        transformer.decode_step(cfg, model, cache, tok, seq)   # warm-up
        out["decode_step"] = profiled(
            lambda: transformer.decode_step(cfg, model, cache, tok, seq + 1))
    return out


def families(dev, entries) -> None:
    """The other LM families, counted: ``launch.serve.run`` serves
    mamba2-130m, zamba2-2.7b, granite-moe-3b-a800m and internvl2-1b at
    their published widths and depths, and qwen3-moe-235b-a22b at its
    widths with the depth cut to 2, in bf16 with the CUDA flash kernel
    (``flash_pallas``); ``transformer.prefill``'s encoder branch runs
    hubert-xlarge's forward, bidirectional.  Then, uncounted: each whole
    path in f32 at depth 2 against the chunked path, the flash forward
    against its plain version at each new layer shape, at the batch and
    positions its serving run gives it, and one AdamW step of five
    families at depth 2 in f32, kernels against chunked, with its
    launches counted.  The launch counts of the runs join the flash
    entries in ``entries`` (the ``kernels`` line) as
    ``launches_families``."""
    import dataclasses

    import torch

    import repro_torch.configs as C
    from repro_torch.core.device import Timer
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import stencil2d as st
    from repro_torch.kernels import stencil3d as st3
    from repro_torch.launch import serve
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import loss_fn, make_train_step

    smi = smi_line()
    counts = {"flash_attention": {}, "flash_attention_bwd": {},
              "flash_attention_f32": {}, "flash_attention_bwd_f32": {}}

    def no_other_kernel(what):
        check(st.ebisu2d_padded.launches == 0 and st3.ebisu3d_padded.launches
              == 0, f"{what} launched a stencil kernel")

    # ---- serving at the published widths, bf16, counted ------------------
    for arch, batch, prompt, new, depth in FAMILY_SERVE:
        name = arch
        if depth is not None:       # a cut config, registered for the run
            name = f"{arch} (depth {depth})"
            C.register(dataclasses.replace(C.get_config(arch), name=name,
                                           n_layers=depth))
        cfg = C.get_config(name)
        zero_counts()
        t0 = time.perf_counter()
        res = serve.run(name, batch=batch, prompt_len=prompt, max_new=new,
                        reduced=False, seed=0, repeats=FAMILY_REPEATS,
                        device=dev, attention_impl="flash_pallas")
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        launches = fa.flash_attention_fwd.launches
        want = attention_calls(cfg)
        print(f"[main path families] {name}: flash_attention launches "
              f"{launches} ({res.kernel_launches_per_prefill} per prefill, "
              f"{1 + FAMILY_REPEATS} prefills)", flush=True)
        no_other_kernel(name)
        check(fa.flash_attention_bwd_dq.launches == 0
              and fa.flash_attention_bwd_dkdv.launches == 0,
              f"{name}: serving launched a backward kernel")
        check(res.kernel_launches_per_prefill == want,
              f"{name}: {res.kernel_launches_per_prefill} flash launches per "
              f"prefill, not {want}")
        check(launches == want * (1 + FAMILY_REPEATS),
              f"{name}: {launches} flash launches, not "
              f"{want * (1 + FAMILY_REPEATS)}")
        check(tuple(res.tokens.shape) == (batch, new)
              and int(res.tokens.min()) >= 0
              and int(res.tokens.max()) < cfg.vocab, f"{name}: tokens")
        counts["flash_attention"][name] = launches
        seq = prompt + (cfg.vlm_patches if cfg.family == "vlm" else 0)
        row = dict(arch=arch, family=cfg.family, n_layers=cfg.n_layers,
                   depth_cut=depth is not None, n_params=cfg.n_params(),
                   n_active_params=cfg.n_active_params(), batch=batch,
                   prompt_tokens=prompt, positions=seq, new_tokens=new,
                   dtype="bfloat16", prefill_ms=res.prefill_ms,
                   prefill_tok_per_s=batch * seq / (res.prefill_ms * 1e-3),
                   decode_ms_per_step=res.decode_ms / res.decode_steps,
                   decode_tok_per_s=res.decode_tok_per_s,
                   launches_per_prefill=res.kernel_launches_per_prefill,
                   peak_gb=res.peak_bytes / 1e9, host_s_with_init=host_s,
                   card=smi)
        print("[families serve] " + json.dumps(row), flush=True)
        del res
        torch.cuda.empty_cache()
        prof = family_profiles(dataclasses.replace(
            cfg, attention_impl="flash_pallas"), batch, seq, dev)
        print(f"[families profile] {name} B{batch} S{seq}: "
              f"{json.dumps(dict(prof, card=smi))}", flush=True)
        torch.cuda.empty_cache()

    # the encoder: transformer.prefill's encoder branch, bidirectional
    cfg = dataclasses.replace(C.get_config(ENCODER_ARCH),
                              attention_impl="flash_pallas")
    torch.cuda.reset_peak_memory_stats(dev)
    model = init_params(transformer.build_model(cfg, dev),
                        torch.Generator(dev).manual_seed(0))
    frames = family_batch(cfg, ENCODER_BATCH, ENCODER_FRAMES,
                          torch.Generator(dev).manual_seed(1), dev)
    del frames["mask"]
    causal_flags = []
    launch = fa._launch

    def spy(q, k, v, causal, window, with_lse):
        causal_flags.append(causal)
        return launch(q, k, v, causal, window, with_lse)

    zero_counts()
    fa._launch = spy
    try:
        transformer.prefill(cfg, model, frames, 0)       # warm-up, counted
        torch.cuda.synchronize()
    finally:
        fa._launch = launch
    launches = fa.flash_attention_fwd.launches
    print(f"[main path families] {ENCODER_ARCH}: flash_attention launches "
          f"{launches}, causal flags {sorted(set(causal_flags))}", flush=True)
    no_other_kernel(ENCODER_ARCH)
    check(launches == cfg.n_layers == len(causal_flags)
          and not any(causal_flags), f"{ENCODER_ARCH}: {launches} launches "
          f"with causal flags {set(causal_flags)}, not {cfg.n_layers} "
          "bidirectional")
    counts["flash_attention"][ENCODER_ARCH] = launches
    best = float("inf")
    for _ in range(FAMILY_REPEATS):
        with Timer(dev) as t:
            logits, cache = transformer.prefill(cfg, model, frames, 0)
        best = min(best, t.ms)
    check(cache == {} and tuple(logits.shape) == (ENCODER_BATCH, 1, cfg.vocab)
          and bool(torch.isfinite(logits).all()), "encoder logits")
    row = dict(arch=ENCODER_ARCH, family="encoder", n_layers=cfg.n_layers,
               n_params=cfg.n_params(), batch=ENCODER_BATCH,
               frames=ENCODER_FRAMES, dtype="bfloat16", forward_ms=best,
               frames_per_s=ENCODER_BATCH * ENCODER_FRAMES / (best * 1e-3),
               launches_per_forward=launches,
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9, card=smi)
    print("[families serve] " + json.dumps(row), flush=True)
    del model, frames, logits
    torch.cuda.empty_cache()
    prof = family_profiles(cfg, ENCODER_BATCH, ENCODER_FRAMES, dev)
    print(f"[families profile] {ENCODER_ARCH} B{ENCODER_BATCH} "
          f"S{ENCODER_FRAMES}: {json.dumps(dict(prof, card=smi))}",
          flush=True)
    torch.cuda.empty_cache()

    # ---- the whole paths, f32, depth 2: kernel vs chunked, uncounted -----
    whole = {}
    batch, seq = 1, FAMILY_WHOLE_PATH_SEQ
    for arch in FAMILY_WHOLE_PATH:
        cfg = dataclasses.replace(C.get_config(arch), n_layers=2,
                                  activ_dtype=torch.float32,
                                  param_dtype=torch.float32)
        model = init_params(transformer.build_model(cfg, dev),
                            torch.Generator(dev).manual_seed(0))
        prompt = family_batch(cfg, batch, seq,
                              torch.Generator(dev).manual_seed(1), dev)
        got = {}
        for impl in ("flash_pallas", "flash_jnp"):
            c = dataclasses.replace(cfg, attention_impl=impl)
            got[impl], _ = transformer.prefill(c, model, prompt, seq + 8)
        whole[arch] = held(
            got["flash_pallas"], got["flash_jnp"], LM_WHOLE_PATH_TOL,
            f"whole path {arch} f32 depth 2 B{batch} S{seq}: last-position "
            "logits, kernel vs chunked")
        del model, prompt, got
        torch.cuda.empty_cache()

    # ---- the flash forward against its plain version, uncounted ----------
    gen = torch.Generator(dev).manual_seed(2)
    shapes = {}
    for arch, causal, b, s in FAMILY_LAYER_SHAPES:
        cfg = C.get_config(arch)
        h, kv, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
        shape = (f"B{b} S{s} H{h} KV{kv} hd{hd} "
                 f"{'causal' if causal else 'bidirectional'} ({arch})")
        row = {}
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(sh, generator=gen, device=dev).to(dtype)
                       for sh in ((b, s, h, hd), (b, s, kv, hd),
                                  (b, s, kv, hd)))
            out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
            torch.cuda.synchronize()
            want, want_lse = fa.flash_attention_fwd_plain(q, k, v,
                                                          causal=causal)
            name = str(dtype).removeprefix("torch.")
            what = f"flash {name} {shape}"
            if dtype == torch.float32:
                row["max_abs_err_f32"] = held(out, want, 2e-5,
                                              what + ": out vs plain")
            else:
                row["max_abs_err_bf16"], row["bf16_share_of_limit"] = \
                    held_bf16(out, want, what + ": out vs plain")
                # the limit's power: one key less for every row (the
                # diagonal key of a causal row, the last key otherwise),
                # on the rows that keep at least S/2 keys (the chunked
                # path: the dense one's scores would not fit the card)
                if causal:
                    fewer = attn.flash_attention(q, k, v, causal=True,
                                                 q_offset=-1)
                else:
                    fewer, _ = fa.flash_attention_fwd_plain(
                        q, k[:, :-1], v[:, :-1], causal=False)
                rows = slice(s // 2 if causal else 0, None)
                gap = (fewer[:, rows].double() - want[:, rows].double()).abs()
                share = float((gap / (BF16_ATOL + BF16_RTOL * want[
                    :, rows].double().abs())).max())
                print(f"[check] bf16 limit control, {shape}: one key less "
                      f"a row is {share:.2f} of the limit on rows "
                      f"{rows.start}.. (must exceed 1)", flush=True)
                check(share > 1.0, f"the bf16 limit passes one key less a "
                      f"row at {shape}")
                row["bf16_control_share"] = share
                del fewer, gap
            row[f"max_abs_err_lse_{name}"] = held(
                lse, want_lse, 1e-4, what + ": lse vs plain")
            del q, k, v, out, lse, want, want_lse
        shapes[arch] = row
    torch.cuda.empty_cache()

    # ---- one AdamW step, f32, depth 2: kernels vs chunked, counted -------
    trained = {}
    for arch in FAMILY_TRAIN:
        cfg = dataclasses.replace(C.get_config(arch), n_layers=2,
                                  microbatches=1, activ_dtype=torch.float32,
                                  param_dtype=torch.float32)
        calls = attention_calls(cfg)
        model = init_params(transformer.build_model(cfg, dev),
                            torch.Generator(dev).manual_seed(0))
        init = {n: p.detach().clone() for n, p in model.named_parameters()}
        batch = family_batch(cfg, 1, FAMILY_TRAIN_SEQ,
                             torch.Generator(dev).manual_seed(3), dev)
        if cfg.family == "encoder":
            batch["labels"] = torch.randint(
                0, cfg.vocab, batch["mask"].shape, device=dev,
                generator=torch.Generator(dev).manual_seed(4))
        else:
            batch["labels"] = batch["tokens"]
        got = {}
        for impl in ("flash_pallas", "flash_jnp"):
            c = dataclasses.replace(cfg, attention_impl=impl)
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(init[n])
            loss = loss_fn(c, model, batch)
            names, leaves = zip(*model.named_parameters())
            grads = torch.autograd.grad(loss, leaves)
            ocfg = opt.OptConfig(lr=TRAIN_CHECK_LR, warmup=1, total_steps=1,
                                 schedule=c.schedule)
            ostate = opt.init_state(model)
            zero_counts()
            make_train_step(c, ocfg)(model, ostate, batch)
            torch.cuda.synchronize()
            launched = (fa.flash_attention_fwd.launches,
                        fa.flash_attention_bwd_dq.launches,
                        fa.flash_attention_bwd_dkdv.launches)
            no_other_kernel(f"{arch} train step")
            want = ((2 * calls, calls, calls) if impl == "flash_pallas"
                    else (0, 0, 0))
            check(launched == want, f"{arch} {impl} train step launched "
                  f"{launched} (forward, dQ, dK/dV), not {want}")
            if impl == "flash_pallas":
                print(f"[main path families] {arch} train step (depth 2, "
                      f"remat): flash launches forward {launched[0]}, "
                      f"dQ {launched[1]}, dK/dV {launched[2]}", flush=True)
                counts["flash_attention"][arch + " train"] = launched[0]
                counts["flash_attention_bwd"][arch + " train"] = launched[2]
                # f32 steps: the float32 kernels' launches
                counts["flash_attention_f32"][arch + " train"] = launched[0]
                counts["flash_attention_bwd_f32"][arch + " train"] = \
                    launched[2]
            got[impl] = dict(loss=float(loss.detach()),
                             grads=dict(zip(names, grads)),
                             params={n: p.detach().clone()
                                     for n, p in model.named_parameters()})
            del ostate, loss, grads
            torch.cuda.empty_cache()
        k_, c_ = got["flash_pallas"], got["flash_jnp"]
        loss_err = abs(k_["loss"] - c_["loss"])
        check(math.isfinite(k_["loss"]) and loss_err < TRAIN_LOSS_TOL,
              f"{arch} train f32 depth 2: loss {k_['loss']} vs {c_['loss']}")
        grad_share = 0.0
        for n, g in k_["grads"].items():
            w = c_["grads"][n]
            check(bool(torch.isfinite(g).all()), f"{arch} grad {n}: "
                  "non-finite")
            lim = TRAIN_GRAD_TOL * float(w.abs().max())
            err = float((g.double() - w.double()).abs().max())
            check(err <= lim, f"{arch} grad {n}: max|err| {err:.3e} > "
                  f"{lim:.3e}")
            grad_share = max(grad_share, err / lim if lim else 0.0)
        param_err = max(float((p - c_["params"][n]).abs().max())
                        for n, p in k_["params"].items())
        check(param_err < TRAIN_PARAM_TOL, f"{arch} params after one AdamW "
              f"step: max|err| {param_err:.3e} >= {TRAIN_PARAM_TOL:g}")
        table = "head" if "head" in init else "embed.table"
        moved = float((k_["params"][table] - init[table]).abs().median())
        check(moved > 0.5 * TRAIN_CHECK_LR, f"{arch}: the step moved "
              f"{table} by a median {moved:.3e} only")
        trained[arch] = dict(loss=k_["loss"], loss_err=loss_err,
                             grad_share_of_limit=grad_share,
                             param_err=param_err, moved_median=moved)
        print(f"[check] {arch} train f32 depth 2 B1 S{FAMILY_TRAIN_SEQ}: "
              f"loss {k_['loss']:.6f}, kernels vs chunked |err| "
              f"{loss_err:.3e} (< {TRAIN_LOSS_TOL:g}); every gradient leaf "
              f"within {TRAIN_GRAD_TOL:g} of its largest |value| (at most "
              f"{grad_share:.4f} of that limit); parameters after the step "
              f"max|err| {param_err:.3e} (< {TRAIN_PARAM_TOL:g}); {table} "
              f"moved by a median {moved:.3e}", flush=True)
        del model, init, got, k_, c_, batch
        torch.cuda.empty_cache()
    print("[families] " + json.dumps(dict(
        whole_path_f32_max_abs_err=whole, layer_shapes=shapes,
        train=trained, launches=counts, card=smi)), flush=True)
    for e in entries:
        if e["name"] in counts:
            e["launches_families"] = counts[e["name"]]


# the mesh phase: a (2, 2) (data, model) mesh of cuda:0 × 4 (the shards
# share the card; collectives are on-device copies)
MESH_SHAPE = (2, 2)
MESH_REPEATS = 1
MESH_TRAIN_STEPS, MESH_TRAIN_BATCH = 2, 4     # 2 microbatches of 2 × 8192
MOE_ARCH, SSM_ARCH = "granite-moe-3b-a800m", "mamba2-130m"
MESH_CHECK_BATCH, MESH_CHECK_SEQ = 4, 1024    # the f32 depth-2 checks
# apply_moe_ep at granite's widths, f32: capacity factor 1.0 drops slots,
# and 2 × 640 tokens a data shard give a capacity of 1280·8/40 = 256,
# where the dense dispatch's rounding to 256 leaves it as it is
MOE_CHECK_SEQ, MOE_CHECK_CF = 640, 1.0
MOE_EP_TOL = 1e-4                             # f32, EP vs its oracle
# f32, one AdamW step's update on the mesh against the unsharded one, a
# share of the learning rate: Adam's first step moves an element by about
# lr, so a slice the mesh left in place misses by about 4x this limit
MESH_STEP_DELTA_TOL = 0.25


def lm_mesh(devs):
    """The (2, 2) ``(data, model)`` mesh of ``devs``."""
    from repro_torch.launch.mesh import make_host_mesh

    return make_host_mesh(*MESH_SHAPE, devices=devs)


def mesh_layout(cfg, devs) -> tuple:
    """``(flat defs, shardings)`` of ``cfg`` as the mesh executor places
    it on the (2, 2) mesh of ``devs`` (nothing allocated)."""
    from repro_torch.models.parallel import mesh_defs
    from repro_torch.models.params import NamedSharding, flat_defs

    m = lm_mesh(devs)
    flat = flat_defs(mesh_defs(cfg.with_mesh(m), m))
    return flat, {n: NamedSharding(m, d.pspec) for n, d in flat.items()}


def mesh_prefill_collectives(cfg, devs) -> dict:
    """The collectives one prefill of ``cfg`` takes on ``mm``'s mesh:
    per layer a ``psum`` over ``model`` after each row-parallel product
    (attention's ``wo`` and the MLP's ``w_down``; the MoE's output; the
    SSM's gated-norm sums of squares and ``out_proj``), the embedding's
    ``all_gather`` and the logits' ``psum``; the MoE's ZeRO-3
    ``all_gather``s of its three expert weights over ``data`` and the
    ``pmean`` of its aux loss."""
    flat, shardings = mesh_layout(cfg, devs)
    split = {n: flat[n].shape != shardings[n].local_shape(flat[n].shape)
             for n in flat}
    L = cfg.n_layers
    psum = 0
    if cfg.family == "ssm":
        psum += 2 * L * split["blocks.0.ssm.wz"]
    else:
        psum += L * split["blocks.0.attn.wo"]
    if cfg.family == "dense":
        psum += L * split["blocks.0.mlp.w_down"]
    out = {}
    if cfg.family == "moe":
        psum += L
        out["pmean"] = {"data": L}
        out["all_gather"] = {"data": 3 * L}
    table = "head" if "head" in flat else "embed.table"
    psum += split[table]
    out["psum"] = {"model": psum}
    if split["embed.table"]:
        out.setdefault("all_gather", {})["model"] = 1
    return out


def mesh_step_collectives(cfg, devs, seq) -> dict:
    """The collectives one train step of ``cfg`` (dense) takes on
    ``mm``'s mesh.  Each microbatch's forward: the prefill's per-layer
    ``psum``s and the embedding's ``all_gather``, one ``psum`` over
    ``model`` per loss chunk (the split head's logits) and one over
    ``data`` (the sums and counts).  Its backward recomputes each loss
    chunk and, under remat, each layer up to its last saved tensor: the
    attention's ``psum`` (the MLP's last one has nothing after it to
    recompute).  Then a ``psum`` of each leaf over the axes it is
    replicated on, the global norm's over the whole mesh, and one
    ``all_gather`` over ``data`` per leaf whose moments split a free
    dim."""
    from repro_torch.models.params import NamedSharding
    from repro_torch.train.optimizer import zero_pspec

    n_micro = cfg.microbatches
    chunks = -(-seq // min(cfg.loss_chunk, seq))
    fwd = mesh_prefill_collectives(cfg, devs)["psum"]["model"] - 1 + chunks
    bwd = cfg.n_layers * cfg.remat + chunks
    flat, shardings = mesh_layout(cfg, devs)
    m = lm_mesh(devs)
    rep = {"data": 0, "data+model": 0}
    zero = 0
    for n, d in flat.items():
        rep["+".join(shardings[n].replica_axes(d.shape))] += 1
        moments = NamedSharding(m, zero_pspec(d, data_size=MESH_SHAPE[0]))
        zero += (moments.local_shape(d.shape)
                 != shardings[n].local_shape(d.shape))
    return {"psum": {"model": n_micro * (fwd + bwd),
                     "data": n_micro + rep["data"],
                     "data+model": rep["data+model"] + 1},
            "all_gather": {"model": n_micro, "data": zero}}


def mesh(dev, entries) -> None:
    """LM-side parallelism on a (2, 2) ``(data, model)`` mesh of
    ``cuda:0`` × 4, counted: ``launch.serve.run(n_data=2, n_model=2)``
    serves h2o-danube-1.8b at its published widths and depth (bf16, 4
    prompts of 8192 tokens, 32 greedy tokens; the flash forward once per
    layer per shard, 96 a prefill, at 2 rows and 16 of 32 heads), and
    ``launch.train.train`` takes two steps of 4 × 8192 tokens
    (``microbatches=2``, remat; each microbatch 1 + 1 rows over
    ``data``); ``transformer.prefill`` of granite-moe-3b-a800m (expert
    parallel: 24 of 48 padded experts a model shard, ZeRO-3 gathered
    over ``data``; 4 × 8192) and ``launch.serve.run`` of mamba2-130m
    (12 of 24 SSM heads a shard; 4 × 8192, 32 tokens).  Every launch and
    collective count is held to its prediction.  Then, uncounted, in f32
    at depth 2 on the card: h2o's sharded prefill and train step against
    the unsharded ones (logits < 1e-4; loss < 1e-4; each gradient leaf
    within 1e-4 of its largest |value|; parameters after one AdamW step
    < 2e-4, the update within 0.25·lr, each ZeRO slice of a densely
    updated leaf moved by a median above lr/2), ``apply_moe_ep`` at
    granite's widths against its oracle (each data shard's dense
    dispatch at the same capacity), mamba2's sharded prefill and decode
    against the unsharded ones; the flash forward at each per-shard shape
    against its plain version, and the backward kernels at the train
    step's per-shard shape (with the window − 1 control).  The
    launch counts join the flash entries in ``entries`` as
    ``launches_mesh``."""
    import dataclasses

    import numpy as np
    import torch

    import repro_torch.configs as C
    from repro_torch.core import distributed as D
    from repro_torch.core.device import Timer
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import stencil2d as st
    from repro_torch.kernels import stencil3d as st3
    from repro_torch.launch import serve
    from repro_torch.launch import train as trainer
    from repro_torch.launch.mesh import ensure_fake_devices
    from repro_torch.models import attention as attn
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer
    from repro_torch.models.parallel import MeshModel, replica_grads
    from repro_torch.models.params import (NamedSharding, ParamModule,
                                           init_params)
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import loss_fn, make_train_step

    smi = smi_line()
    devs = ensure_fake_devices(math.prod(MESH_SHAPE), dev)
    n_shards = len(devs)
    counts = {"flash_attention": {}, "flash_attention_bwd": {}}
    rows = {}

    def no_other_kernel(what):
        check(st.ebisu2d_padded.launches == 0 and st3.ebisu3d_padded.launches
              == 0, f"{what} launched a stencil kernel")

    def unsharded(entry_name, key):
        for e in entries:
            if e["name"] == entry_name and key in e:
                return e[key]
        return "not run (its phase was not selected)"

    # ---- h2o-danube-1.8b served on the mesh, bf16, counted --------------
    cfg = C.get_config(LM_ARCH)
    zero_counts()
    t0 = time.perf_counter()
    res = serve.run(LM_ARCH, batch=LM_BATCH, prompt_len=LM_PROMPT,
                    max_new=LM_NEW, reduced=False, seed=0,
                    repeats=MESH_REPEATS, device=dev, n_data=MESH_SHAPE[0],
                    n_model=MESH_SHAPE[1], attention_impl="flash_pallas")
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = fa.flash_attention_fwd.launches
    want = cfg.n_layers * n_shards
    want_coll = mesh_prefill_collectives(cfg, devs)
    print(f"[main path mesh] {LM_ARCH} (2, 2): flash_attention launches "
          f"{launches} ({res.kernel_launches_per_prefill} per prefill, "
          f"{1 + MESH_REPEATS} prefills); collectives per prefill "
          f"{json.dumps(res.collectives_per_prefill)}", flush=True)
    no_other_kernel(LM_ARCH)
    check(fa.flash_attention_bwd_dq.launches == 0
          and fa.flash_attention_bwd_dkdv.launches == 0,
          "mesh serving launched a backward kernel")
    check(res.kernel_launches_per_prefill == want, f"{LM_ARCH} mesh: "
          f"{res.kernel_launches_per_prefill} flash launches a prefill, not "
          f"{want} (layers × shards)")
    check(launches == want * (1 + MESH_REPEATS), f"{LM_ARCH} mesh: "
          f"{launches} flash launches, not {want * (1 + MESH_REPEATS)}")
    check(res.collectives_per_prefill == want_coll, f"{LM_ARCH} mesh: "
          f"collectives {res.collectives_per_prefill}, not {want_coll}")
    check(tuple(res.tokens.shape) == (LM_BATCH, LM_NEW)
          and int(res.tokens.min()) >= 0
          and int(res.tokens.max()) < cfg.vocab, "mesh tokens")
    counts["flash_attention"][LM_ARCH + " serve"] = launches
    lm = unsharded("flash_attention", "lm")
    rows["serve"] = dict(
        arch=LM_ARCH, mesh=list(MESH_SHAPE), batch=LM_BATCH,
        prompt=LM_PROMPT, new_tokens=LM_NEW, dtype="bfloat16",
        prefill_ms=res.prefill_ms,
        prefill_tok_per_s=LM_BATCH * LM_PROMPT / (res.prefill_ms * 1e-3),
        decode_ms_per_step=res.decode_ms / res.decode_steps,
        decode_tok_per_s=res.decode_tok_per_s,
        launches_per_prefill=res.kernel_launches_per_prefill,
        collectives_per_prefill=res.collectives_per_prefill,
        peak_gb=res.peak_bytes / 1e9, host_s_with_init=host_s,
        unsharded=(lm if isinstance(lm, str) else {
            k: lm[k] for k in ("prefill_ms", "decode_ms_per_step",
                               "peak_gb")}), card=smi)
    print("[mesh serve] " + json.dumps(rows["serve"]), flush=True)
    del res
    torch.cuda.empty_cache()
    # where a mesh prefill's and decode step's time goes (profiled)
    pcfg = dataclasses.replace(cfg, attention_impl="flash_pallas")
    mesh_ = lm_mesh(devs)
    pcfg = pcfg.with_mesh(mesh_)
    mm = MeshModel(pcfg, mesh_, init_params(
        transformer.build_model(pcfg, dev),
        torch.Generator(dev).manual_seed(0)))
    prompt = family_batch(pcfg, LM_BATCH, LM_PROMPT,
                          torch.Generator(dev).manual_seed(1), dev)
    logits, cache = transformer.prefill(pcfg, mm, prompt, LM_PROMPT + 8)
    prof = {"prefill": profiled(lambda: transformer.prefill(
        pcfg, mm, prompt, LM_PROMPT + 8))}
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    transformer.decode_step(pcfg, mm, cache, tok, LM_PROMPT)   # warm-up
    prof["decode_step"] = profiled(lambda: transformer.decode_step(
        pcfg, mm, cache, tok, LM_PROMPT + 1))
    print(f"[mesh profile] {LM_ARCH} (2, 2) B{LM_BATCH} S{LM_PROMPT}: "
          f"{json.dumps(dict(prof, card=smi))}", flush=True)
    del mm, prompt, logits, cache
    torch.cuda.empty_cache()

    # ---- one train step on the mesh, bf16, counted -----------------------
    n_micro = cfg.microbatches
    zero_counts()
    D.reset_collectives()
    t0 = time.perf_counter()
    mm, state, losses = trainer.train(
        LM_ARCH, steps=MESH_TRAIN_STEPS, batch=MESH_TRAIN_BATCH,
        seq=TRAIN_SEQ, reduced=False, device=dev, n_data=MESH_SHAPE[0],
        n_model=MESH_SHAPE[1], attention_impl="flash_pallas", log_every=1)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    stats = trainer.train.last_stats
    coll = D.collective_counts()
    fwd = fa.flash_attention_fwd.launches
    dq_n = fa.flash_attention_bwd_dq.launches
    dkdv_n = fa.flash_attention_bwd_dkdv.launches
    per = cfg.n_layers * n_micro * MESH_TRAIN_STEPS * n_shards
    one = mesh_step_collectives(cfg, devs, TRAIN_SEQ)
    want_coll = {k: {a: n * MESH_TRAIN_STEPS for a, n in v.items()}
                 for k, v in one.items()}
    print(f"[main path mesh] {LM_ARCH} train (2, 2): flash launches forward "
          f"{fwd}, dQ {dq_n}, dK/dV {dkdv_n}; collectives "
          f"{json.dumps(coll)}", flush=True)
    no_other_kernel(LM_ARCH + " train")
    check(fwd == 2 * per and dq_n == per and dkdv_n == per,
          f"mesh train launched ({fwd}, {dq_n}, {dkdv_n}), not "
          f"({2 * per}, {per}, {per}) (layers × microbatches × steps × "
          "shards, the forward twice for remat)")
    check(coll == want_coll, f"mesh train collectives {coll}, not "
          f"{want_coll}")
    check(len(losses) == MESH_TRAIN_STEPS and all(
        math.isfinite(x) for x in losses + stats.grad_norms),
        f"mesh train losses {losses}, grad norms {stats.grad_norms}")
    counts["flash_attention"][LM_ARCH + " train"] = fwd
    counts["flash_attention_bwd"][LM_ARCH + " train"] = dkdv_n
    tr = unsharded("flash_attention_bwd", "train")
    rows["train"] = dict(
        arch=LM_ARCH, mesh=list(MESH_SHAPE), steps=MESH_TRAIN_STEPS,
        batch=MESH_TRAIN_BATCH, seq=TRAIN_SEQ, microbatches=n_micro,
        remat=cfg.remat, dtype="bfloat16", losses=losses,
        grad_norms=stats.grad_norms, step_ms=stats.step_ms,
        timed_steps=stats.timed_steps, tokens_per_s=stats.tokens_per_s,
        peak_gb=stats.peak_bytes / 1e9, host_s_with_init=host_s,
        launches_fwd=fwd, launches_dq=dq_n, launches_dkdv=dkdv_n,
        collectives_per_step=one,
        unsharded=(tr if isinstance(tr, str) else {
            k: tr[k] for k in ("batch", "step_ms", "tokens_per_s",
                               "peak_gb")}), card=smi)
    print("[mesh train] " + json.dumps(rows["train"]), flush=True)
    del mm, state
    torch.cuda.empty_cache()

    # ---- granite-moe-3b-a800m: one expert-parallel prefill, counted ------
    mcfg = dataclasses.replace(C.get_config(MOE_ARCH),
                               attention_impl="flash_pallas")
    mesh_ = lm_mesh(devs)
    mcfg = mcfg.with_mesh(mesh_)
    torch.cuda.reset_peak_memory_stats(dev)
    mm = MeshModel(mcfg, mesh_, init_params(
        transformer.build_model(mcfg, dev),
        torch.Generator(dev).manual_seed(0)))
    e_loc = mm.flat["blocks.0.moe.w_up"].shape[0] // MESH_SHAPE[1]
    check(mm.leaves()["blocks.0.moe.w_up"].flat[0].shape[0] == e_loc
          == mcfg.n_experts_padded // MESH_SHAPE[1],
          f"{MOE_ARCH}: {e_loc} experts a model shard")
    prompt = family_batch(mcfg, LM_BATCH, LM_PROMPT,
                          torch.Generator(dev).manual_seed(1), dev)
    transformer.prefill(mcfg, mm, prompt, LM_PROMPT + 8)     # warm-up
    zero_counts()
    D.reset_collectives()
    with Timer(dev) as t:
        logits, _ = transformer.prefill(mcfg, mm, prompt, LM_PROMPT + 8)
    coll = D.collective_counts()
    launches = fa.flash_attention_fwd.launches
    want = mcfg.n_layers * n_shards
    want_coll = mesh_prefill_collectives(mcfg, devs)
    print(f"[main path mesh] {MOE_ARCH} (2, 2): flash_attention launches "
          f"{launches}; collectives {json.dumps(coll)}", flush=True)
    no_other_kernel(MOE_ARCH)
    check(launches == want, f"{MOE_ARCH} mesh: {launches} flash launches, "
          f"not {want}")
    check(coll == want_coll, f"{MOE_ARCH} mesh: collectives {coll}, not "
          f"{want_coll}")
    check(tuple(logits.shape) == (LM_BATCH, 1, mcfg.vocab)
          and bool(torch.isfinite(logits).all()), f"{MOE_ARCH} logits")
    counts["flash_attention"][MOE_ARCH + " prefill"] = launches
    rows["moe"] = dict(arch=MOE_ARCH, mesh=list(MESH_SHAPE),
                       experts_per_model_shard=e_loc, batch=LM_BATCH,
                       prompt=LM_PROMPT, dtype="bfloat16", prefill_ms=t.ms,
                       prefill_tok_per_s=LM_BATCH * LM_PROMPT
                       / (t.ms * 1e-3), launches_per_prefill=launches,
                       collectives_per_prefill=coll,
                       peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                       card=smi)
    print("[mesh moe] " + json.dumps(rows["moe"]), flush=True)
    del mm, prompt, logits
    torch.cuda.empty_cache()

    # ---- mamba2-130m served on the mesh, counted -------------------------
    scfg = C.get_config(SSM_ARCH)
    zero_counts()
    res = serve.run(SSM_ARCH, batch=LM_BATCH, prompt_len=LM_PROMPT,
                    max_new=LM_NEW, reduced=False, seed=0,
                    repeats=MESH_REPEATS, device=dev, n_data=MESH_SHAPE[0],
                    n_model=MESH_SHAPE[1], attention_impl="flash_pallas")
    torch.cuda.synchronize()
    want_coll = mesh_prefill_collectives(scfg, devs)
    flat, shardings = mesh_layout(scfg, devs)
    heads = shardings["blocks.0.ssm.wz"].local_shape(
        flat["blocks.0.ssm.wz"].shape)[1] // scfg.ssm_head_dim
    print(f"[main path mesh] {SSM_ARCH} (2, 2): {heads} SSM heads a shard; "
          f"flash launches {fa.flash_attention_fwd.launches}; collectives "
          f"per prefill {json.dumps(res.collectives_per_prefill)}",
          flush=True)
    no_other_kernel(SSM_ARCH)
    check(fa.flash_attention_fwd.launches == 0, f"{SSM_ARCH} launched the "
          "flash kernel")
    check(heads * MESH_SHAPE[1] == scfg.ssm_heads, f"{SSM_ARCH}: {heads} "
          "heads a shard")
    check(res.collectives_per_prefill == want_coll, f"{SSM_ARCH} mesh: "
          f"collectives {res.collectives_per_prefill}, not {want_coll}")
    check(tuple(res.tokens.shape) == (LM_BATCH, LM_NEW)
          and int(res.tokens.max()) < scfg.vocab, f"{SSM_ARCH} tokens")
    counts["flash_attention"][SSM_ARCH + " serve"] = 0
    rows["ssm"] = dict(
        arch=SSM_ARCH, mesh=list(MESH_SHAPE), ssm_heads_per_shard=heads,
        batch=LM_BATCH, prompt=LM_PROMPT, new_tokens=LM_NEW,
        dtype="bfloat16", prefill_ms=res.prefill_ms,
        decode_ms_per_step=res.decode_ms / res.decode_steps,
        collectives_per_prefill=res.collectives_per_prefill,
        peak_gb=res.peak_bytes / 1e9, card=smi)
    print("[mesh ssm] " + json.dumps(rows["ssm"]), flush=True)
    del res
    torch.cuda.empty_cache()

    # ---- f32, depth 2: sharded against unsharded, uncounted --------------
    checks = {}
    f32 = dict(n_layers=2, activ_dtype=torch.float32,
               param_dtype=torch.float32, attention_impl="flash_pallas")
    b, s = MESH_CHECK_BATCH, MESH_CHECK_SEQ
    for arch in (LM_ARCH, SSM_ARCH):
        c1 = dataclasses.replace(C.get_config(arch), **f32)
        model = init_params(transformer.build_model(c1, dev),
                            torch.Generator(dev).manual_seed(0))
        mesh_ = lm_mesh(devs)
        cm = c1.with_mesh(mesh_)
        mm = MeshModel(cm, mesh_, model)
        toks = torch.randint(0, c1.vocab, (b, s), device=dev,
                             generator=torch.Generator(dev).manual_seed(1))
        want_l, want_c = transformer.prefill(c1, model, {"tokens": toks},
                                             s + 8)
        got_l, got_c = transformer.prefill(cm, mm, {"tokens": toks}, s + 8)
        row = {"prefill_logits": held(
            got_l, want_l, LM_WHOLE_PATH_TOL, f"mesh {arch} f32 depth 2 "
            f"B{b} S{s}: last-position logits, (2, 2) vs unsharded")}
        tok = torch.argmax(want_l[:, -1], dim=-1)[:, None]
        want_d, _ = transformer.decode_step(c1, model, want_c, tok, s)
        got_d, _ = transformer.decode_step(cm, mm, got_c, tok, s)
        row["decode_logits"] = held(
            got_d, want_d, LM_WHOLE_PATH_TOL, f"mesh {arch} f32 depth 2: "
            "decode-step logits, (2, 2) vs unsharded")
        del want_c, got_c
        if arch == LM_ARCH:
            batch = {"tokens": toks, "labels": toks}
            names, leaves = zip(*model.named_parameters())
            loss = loss_fn(c1, model, batch)
            want_g = dict(zip(names, torch.autograd.grad(loss, leaves)))
            shards = mm.leaves()
            keys = [(n, c) for n in shards for c in np.ndindex(
                *mesh_.devices.shape)]
            mloss = loss_fn(cm, mm, batch)
            gs = torch.autograd.grad(mloss, [shards[n][c] for n, c in keys])
            grads = {n: np.empty(mesh_.devices.shape, dtype=object)
                     for n in shards}
            for (n, c), g in zip(keys, gs):
                grads[n][c] = g
            grads = replica_grads(mm, grads)
            loss_err = abs(float(mloss.detach()) - float(loss.detach()))
            check(loss_err < TRAIN_LOSS_TOL, f"mesh {arch} loss "
                  f"{float(mloss.detach())} vs {float(loss.detach())}")
            share = 0.0
            for n in names:
                got = mm.shardings[n].gather(grads[n], mm.flat[n].shape, dev)
                lim = TRAIN_GRAD_TOL * float(want_g[n].abs().max())
                err = float((got.double() - want_g[n].double()).abs().max())
                check(err <= lim, f"mesh {arch} grad {n}: {err:.3e} > "
                      f"{lim:.3e}")
                share = max(share, err / lim if lim else 0.0)
            del grads, gs, want_g
            ocfg = opt.OptConfig(lr=TRAIN_CHECK_LR, warmup=1, total_steps=1,
                                 schedule=c1.schedule)
            before = {n: p.detach().clone()
                      for n, p in model.named_parameters()}
            make_train_step(c1, ocfg)(model, opt.init_state(model), batch)
            mstate = opt.init_state(mm)
            make_train_step(cm, ocfg)(mm, mstate, batch)
            got_p = mm.state_dict(dev)
            perr = max(float((got_p[n] - p).abs().max())
                       for n, p in model.named_parameters())
            check(perr < TRAIN_PARAM_TOL, f"mesh {arch} params after one "
                  f"AdamW step: {perr:.3e}")
            # the step's update itself, held below the learning rate; and
            # on every leaf the reference moves densely, each data
            # shard's ZeRO slice moved by a median of at least lr / 2
            lr = TRAIN_CHECK_LR
            derr, dense = 0.0, []
            for n, p in model.named_parameters():
                want_d = p.detach() - before[n]
                got_d = got_p[n] - before[n]
                derr = max(derr, float((got_d - want_d).abs().max()))
                if float(want_d.abs().median()) <= 0.5 * lr:
                    continue                    # a sparse update
                zs = mstate["m"][n].sharding
                for c in np.ndindex(*mesh_.devices.shape):
                    med = float(got_d[zs.index(c, got_d.shape)].abs()
                                .median())
                    check(med > 0.5 * lr, f"mesh {arch}: the step moved "
                          f"{n}'s ZeRO slice at {c} by a median {med:.3e}")
                dense.append(n)
            check(derr < MESH_STEP_DELTA_TOL * lr, f"mesh {arch}: the "
                  f"AdamW update differs by {derr:.3e}, lr {lr:g}")
            check(len(dense) >= len(before) - 1, f"mesh {arch}: only "
                  f"{len(dense)} of {len(before)} leaves moved densely")
            row.update(loss=float(loss.detach()), loss_err=loss_err,
                       grad_share_of_limit=share, param_err=perr,
                       update_err=derr, dense_leaves=len(dense),
                       microbatches=c1.microbatches)
            print(f"[check] mesh {arch} f32 depth 2 B{b} S{s} train step "
                  f"({c1.microbatches} microbatches): loss |err| "
                  f"{loss_err:.3e} (< {TRAIN_LOSS_TOL:g}); gradients at "
                  f"most {share:.4f} of their limit; parameters after the "
                  f"step max|err| {perr:.3e} (< {TRAIN_PARAM_TOL:g}); the "
                  f"update max|err| {derr:.3e} (< {MESH_STEP_DELTA_TOL:g}"
                  f"·lr); {len(dense)} of {len(before)} leaves moved by a "
                  f"median > lr/2 in every ZeRO slice", flush=True)
            del got_p, before, mstate
        checks[arch] = row
        del model, mm
        torch.cuda.empty_cache()

    # ---- apply_moe_ep at granite's widths against its oracle, f32 --------
    gc = C.get_config(MOE_ARCH)
    defs, e_pad = moe_mod.moe_defs(gc.d_model, gc.d_ff, gc.n_experts,
                                   act=gc.act)
    p = init_params(ParamModule(defs, device=dev),
                    torch.Generator(dev).manual_seed(0))
    s = MOE_CHECK_SEQ
    x = torch.randn((b, s, gc.d_model), device=dev,
                    generator=torch.Generator(dev).manual_seed(1))
    mesh_ = lm_mesh(devs)
    full = dict(p.named_parameters())
    ps = np.empty(mesh_.devices.shape, dtype=object)
    parts = {n: NamedSharding(mesh_, d.pspec).split(full[n].detach())
             for n, d in defs.items()}
    for c in np.ndindex(*ps.shape):
        ps[c] = ParamModule({n: dataclasses.replace(
            d, shape=tuple(parts[n][c].shape)) for n, d in defs.items()},
            device=dev)
        ps[c].load_state_dict({n: parts[n][c] for n in defs})
    kw = dict(n_experts=gc.n_experts, n_padded=e_pad, top_k=gc.top_k,
              act=gc.act, capacity_factor=MOE_CHECK_CF)
    rows_d = b // MESH_SHAPE[0]
    t_local = rows_d * s
    cap = max(4, int(MOE_CHECK_CF * t_local * gc.top_k / gc.n_experts))
    check(moe_mod.capacity(t_local, gc.top_k, gc.n_experts,
                           MOE_CHECK_CF) == cap,
          "the oracle's capacity differs from the EP capacity")
    with torch.no_grad():
        ys, auxs = moe_mod.apply_moe_ep(
            NamedSharding(mesh_, ("data",)).split(x), ps, mesh_,
            dp_axes="data", **kw)
        ep_err, per_aux, kept = 0.0, [], 0
        for d in range(MESH_SHAPE[0]):
            xd = x[d * rows_d:(d + 1) * rows_d]
            want, a = moe_mod.apply_moe(xd, p, **kw)
            per_aux.append(float(a))
            logits = xd.reshape(-1, gc.d_model) @ full["router"]
            kept += int(moe_mod.route(logits, gc.n_experts, gc.top_k,
                                      cap)[4].sum())
            for m in range(MESH_SHAPE[1]):
                ep_err = max(ep_err, held(
                    ys[d, m], want, MOE_EP_TOL, f"apply_moe_ep {MOE_ARCH} "
                    f"f32 B{b} S{s} data shard {d} model shard {m}: vs its "
                    f"shard's dense dispatch (capacity {cap})"))
        _, glob = moe_mod.apply_moe(x, p, **kw)
    aux = float(auxs.flat[0])
    aux_rel = abs(aux - float(glob)) / float(glob)
    check(abs(aux - sum(per_aux) / len(per_aux)) < 1e-5 and aux_rel < 0.05,
          f"apply_moe_ep aux {aux} vs the shards' mean "
          f"{sum(per_aux) / len(per_aux)} and the global {float(glob)}")
    slots = b * s * gc.top_k
    check(kept < slots, "the EP check dropped no slot")
    print(f"[check] apply_moe_ep aux {aux:.6f}: the data shards' mean, "
          f"{aux_rel:.4f} of the global {float(glob):.6f} (< 0.05); "
          f"{slots - kept} of {slots} slots dropped", flush=True)
    checks["apply_moe_ep"] = dict(max_abs_err=ep_err, capacity=cap,
                                  dropped=slots - kept, slots=slots,
                                  aux=aux, aux_rel_to_global=aux_rel)
    del p, ps, parts, full, x, ys
    torch.cuda.empty_cache()

    # ---- the flash forward at each per-shard shape, uncounted -----------
    gen = torch.Generator(dev).manual_seed(2)
    h2o = C.get_config(LM_ARCH)
    shard_shapes = [
        (LM_ARCH + " serve", h2o, LM_BATCH // 2, LM_PROMPT),
        (LM_ARCH + " train", h2o, MESH_TRAIN_BATCH // n_micro // 2,
         TRAIN_SEQ),
        (MOE_ARCH + " prefill", C.get_config(MOE_ARCH), LM_BATCH // 2,
         LM_PROMPT)]
    shapes = {}
    for what, c1, bb, ss in shard_shapes:
        h, kv, hd = (c1.n_heads // MESH_SHAPE[1], c1.kv_heads
                     // MESH_SHAPE[1], c1.head_dim)
        window = c1.swa_window
        shape = f"B{bb} S{ss} H{h} KV{kv} hd{hd} window {window} ({what})"
        row = {}
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(sh, generator=gen, device=dev).to(dtype)
                       for sh in ((bb, ss, h, hd), (bb, ss, kv, hd),
                                  (bb, ss, kv, hd)))
            out, lse = fa.flash_attention_fwd(q, k, v, window=window)
            torch.cuda.synchronize()
            want, want_lse = fa.flash_attention_fwd_plain(q, k, v,
                                                          window=window)
            name = str(dtype).removeprefix("torch.")
            what_ = f"flash {name} per-shard {shape}"
            if dtype == torch.float32:
                row["max_abs_err_f32"] = held(out, want, 2e-5,
                                              what_ + ": out vs plain")
            else:
                row["max_abs_err_bf16"], row["bf16_share_of_limit"] = \
                    held_bf16(out, want, what_ + ": out vs plain")
                # the limit's power: each row's keys shifted by one (its
                # diagonal key dropped; under a window one older key let
                # in), on the rows that keep at least S/2 keys
                fewer = attn.flash_attention(q, k, v, causal=True,
                                             window=window, q_offset=-1)
                sl = slice(ss // 2, None)
                gap = (fewer[:, sl].double() - want[:, sl].double()).abs()
                share = float((gap / (BF16_ATOL + BF16_RTOL * want[
                    :, sl].double().abs())).max())
                print(f"[check] bf16 limit control, {shape}: keys shifted "
                      f"by one a row is {share:.2f} of the limit on rows "
                      f"{ss // 2}.. (must exceed 1)", flush=True)
                check(share > 1.0, f"the bf16 limit passes keys shifted "
                      f"by one a row at {shape}")
                row["bf16_control_share"] = share
                del fewer, gap
            row[f"max_abs_err_lse_{name}"] = held(
                lse, want_lse, 1e-4, what_ + ": lse vs plain")
            del want, want_lse
            if what.endswith(" train"):
                # the backward kernels the sharded step launched, at its
                # per-shard shape (the window - 1 gradient as control)
                do = torch.randn((bb, ss, h, hd), generator=gen,
                                 device=dev).to(dtype)
                args = (q, k, v, do, out, lse)
                err, sh = bwd_vs_plain(args, True, window, dtype, f"flash "
                                       f"bwd {name} per-shard {shape}")
                row[f"bwd_max_abs_err_{name}"] = err
                if dtype == torch.bfloat16:
                    row["bwd_bf16_share_of_limit"] = sh
                    row["bwd_bf16_control"] = bwd_window_control(
                        args, window, f"per-shard {shape}")
                del do, args
            del q, k, v, out, lse
        shapes[what] = row
    torch.cuda.empty_cache()
    print("[mesh] " + json.dumps(dict(runs=rows, checks=checks,
                                      shard_shapes=shapes, launches=counts,
                                      card=smi)), flush=True)
    for e in entries:
        if e["name"] in counts:
            e["launches_mesh"] = counts[e["name"]]



# the dryrun phase: the shims' domains and depths (the paper's), the
# stubs' and FSDP's shapes (the LM phase's), the dry run's cell
SHIM_2D, SHIM_3D = ("j2d5pt", 12), ("j3d7pt", 17)
SHIM_TOL = 1e-4                       # f32, a shim vs the planned program
SHIM_REPS = 20


def dryrun(dev, entries) -> None:
    """The last Queue-1 paths on the card, counted where they launch: the
    deprecated shims with ``plan=None`` (``ops.ebisu_stencil`` one
    2-D sweep at the request-default tile; ``sweep.run_sweeps`` 17 steps
    of j3d7pt at its bucketed plan, 8, 8 and 1), both boundary stubs,
    ``sharding="fsdp"`` on the (2, 2) mesh of ``cuda:0`` × 4, and the dry
    run (``launch/dryrun.py``, on meta shards) held to the card's runs of
    the same programs.  The shims' launches join the stencil entries as
    ``launches_shims``, the FSDP runs' the flash entries as
    ``launches_fsdp``."""
    import dataclasses

    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    import repro_torch.configs as C
    from repro_torch.api import compile_stencil
    from repro_torch.core import distributed as D
    from repro_torch.core.device import Timer
    from repro_torch.core.stencil_spec import get
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, sweep
    from repro_torch.kernels import stencil2d as st
    from repro_torch.kernels import stencil3d as st3
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import (ensure_fake_devices,
                                         make_host_mesh, make_stencil_mesh)
    from repro_torch.models import transformer
    from repro_torch.models.parallel import MeshModel
    from repro_torch.models.params import init_params
    from repro_torch.stencils.data import init_domain
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import loss_fn, make_train_step

    smi = smi_line()
    devs = ensure_fake_devices(math.prod(MESH_SHAPE), dev)
    n_shards = len(devs)
    rows, counts = {}, {"stencil2d": {}, "stencil3d": {},
                        "flash_attention": {}, "flash_attention_bwd": {}}
    meta4 = make_host_mesh(*MESH_SHAPE, devices=[DR.META] * n_shards)

    def gen(seed):
        return torch.Generator(dev).manual_seed(seed)

    def warned(call, name):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            out = call()
        check(any(issubclass(w.category, DeprecationWarning)
                  and name in str(w.message) for w in seen),
              f"{name} did not warn")
        return out

    def kernel_ms(prog):
        """One sweep of ``prog``'s kernel at its tile, on its padded
        layout (CUDA events, median of ``SHIM_REPS``)."""
        g, spec = prog.geometry(), prog.spec
        xp = torch.zeros(g["padded"], device=dev)
        buf = torch.empty_like(xp)
        if spec.ndim == 2:
            (bh, bw), (h, w) = g["block"], prog.shape

            def fn():
                st.ebisu2d_padded(xp, spec, prog.t, height=h, width=w,
                                  bh=bh, bw=bw, out=buf)
        else:
            zc, ty, tx = g["block"]
            z, y, x = prog.shape

            def fn():
                st3.ebisu3d_padded(xp, spec, prog.t, zdim=z, ydim=y,
                                   xdim=x, zc=zc, ty=ty, tx=tx, out=buf)
        return median_ms(fn, SHIM_REPS, 3), list(g["block"]), \
            g.get("tile_request")

    # ---- the shims with plan=None, counted -------------------------------
    name2, t2 = SHIM_2D
    spec2 = get(name2)
    x2 = init_domain(spec2, spec2.domain, seed=0, device=dev)
    planned2 = compile_stencil(spec2, spec2.domain, t=t2, device=dev)
    want2 = planned2.apply(x2)
    zero_counts()
    got2 = warned(lambda: ops.ebisu_stencil(x2, spec2, t2),
                  "ops.ebisu_stencil")
    torch.cuda.synchronize()
    n2 = st.ebisu2d_padded.launches
    check(n2 == 1 and st3.ebisu3d_padded.launches == 0,
          f"ops.ebisu_stencil launched ({n2}, "
          f"{st3.ebisu3d_padded.launches}), not (1, 0)")
    err2 = held(got2, want2, SHIM_TOL, f"ops.ebisu_stencil {name2} "
                f"{spec2.domain} t={t2} plan=None vs the planned program")
    counts["stencil2d"]["ops.ebisu_stencil " + name2] = n2
    name3, steps3 = SHIM_3D
    spec3 = get(name3)
    x3 = init_domain(spec3, spec3.domain, seed=0, device=dev)
    depth3 = sweep.plan_bucketed(spec3, spec3.domain).t
    want3 = compile_stencil(spec3, spec3.domain, t=depth3,
                            device=dev).run(x3, steps3)
    zero_counts()
    got3 = warned(lambda: sweep.run_sweeps(x3, spec3, steps3),
                  "sweep.run_sweeps")
    torch.cuda.synchronize()
    n3 = st3.ebisu3d_padded.launches
    n3_want = len(sweep.sweep_schedule(steps3, depth3))
    check(n3 == n3_want and st.ebisu2d_padded.launches == 0,
          f"sweep.run_sweeps launched ({st.ebisu2d_padded.launches}, {n3}),"
          f" not (0, {n3_want})")
    err3 = held(got3, want3, SHIM_TOL, f"sweep.run_sweeps {name3} "
                f"{spec3.domain} {steps3} steps plan=None vs the planned "
                "program")
    counts["stencil3d"]["sweep.run_sweeps " + name3] = n3
    print(f"[main path dryrun] shims: ops.ebisu_stencil {n2} stencil2d "
          f"launch; sweep.run_sweeps {n3} stencil3d launches (depth "
          f"{depth3})", flush=True)
    del got2, want2, got3, want3
    tiles = {}
    for spec, x, depth in ((spec2, x2, t2), (spec3, x3, depth3)):
        req = compile_stencil(spec, spec.domain, t=depth, plan=None,
                              device=dev)
        req_ms, req_tile, request = kernel_ms(req)
        plan_ms, plan_tile, _ = kernel_ms(compile_stencil(
            spec, spec.domain, t=depth, device=dev))
        tiles[f"{spec.name} t={depth}"] = dict(
            request_tile=req_tile, request_ms=req_ms, tile_request=request,
            planned_tile=plan_tile, planned_ms=plan_ms,
            ratio=req_ms / plan_ms)
    rows["shims"] = dict(max_abs_err={name2: err2, name3: err3},
                         launches={"stencil2d": n2, "stencil3d": n3},
                         kernel_ms=tiles, reps=SHIM_REPS, card=smi)
    print("[dryrun shims] " + json.dumps(rows["shims"]), flush=True)
    del x2, x3
    torch.cuda.empty_cache()

    # ---- the boundary stubs ----------------------------------------------
    zero_counts()
    stub = serve.run(LM_ARCH, batch=LM_BATCH, prompt_len=LM_PROMPT,
                     max_new=4, reduced=False, seed=0, repeats=2,
                     device=dev, attention_impl="boundary_stub")
    check(fa.flash_attention_fwd.launches == 0
          and stub.kernel_launches_per_prefill == 0,
          "the attention boundary stub launched the flash kernel")
    check(tuple(stub.tokens.shape) == (LM_BATCH, 4) and int(
        stub.tokens.max()) < C.get_config(LM_ARCH).vocab, "stub tokens")
    lm = next((e["lm"] for e in entries if e["name"] == "flash_attention"
               and "lm" in e), None)
    if lm is None:          # the LM phase did not run: serve with the kernel
        flash = serve.run(LM_ARCH, batch=LM_BATCH, prompt_len=LM_PROMPT,
                          max_new=4, reduced=False, seed=0, repeats=2,
                          device=dev, attention_impl="flash_pallas")
        lm = dict(prefill_ms=flash.prefill_ms, peak_gb=flash.peak_bytes
                  / 1e9, source="this phase")
        del flash
    stubs = {"attention": dict(
        arch=LM_ARCH, batch=LM_BATCH, prompt=LM_PROMPT,
        stub_prefill_ms=stub.prefill_ms, flash_prefill_ms=lm["prefill_ms"],
        flash_prefill_from=lm.get("source", "the lm phase"),
        stub_peak_gb=stub.peak_bytes / 1e9, flash_launches=0)}
    del stub
    scan = {}
    for impl in ("chunked_jnp", "boundary_stub"):
        cfg = dataclasses.replace(C.get_config(SSM_ARCH), ssm_impl=impl)
        model = init_params(transformer.build_model(cfg, dev), gen(0))
        toks = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                             generator=gen(1), device=dev)
        logits, cache = transformer.prefill(cfg, model, {"tokens": toks},
                                            LM_PROMPT + 8)
        check(bool(torch.isfinite(logits).all()), f"{SSM_ARCH} {impl} "
              "logits")
        if impl == "boundary_stub":
            check(not any(bool(torch.any(c["state"]))
                          for c in cache["ssm"]),
                  "the SSM stub left a non-zero state")
        del logits, cache
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ms = median_ms(lambda: transformer.prefill(
            cfg, model, {"tokens": toks}, LM_PROMPT + 8), 3, 0)
        scan[impl] = dict(prefill_ms=ms, peak_gb=torch.cuda
                          .max_memory_allocated(dev) / 1e9)
        del model, toks
        torch.cuda.empty_cache()
    stubs["ssm"] = dict(arch=SSM_ARCH, batch=LM_BATCH, prompt=LM_PROMPT,
                        **{k + "_" + m: v for k, r in scan.items()
                           for m, v in r.items()})
    rows["stubs"] = dict(stubs, card=smi)
    print("[dryrun stubs] " + json.dumps(rows["stubs"]), flush=True)

    # ---- sharding="fsdp" on the (2, 2) mesh -------------------------------
    def predicted(cfg, kind, b, s):
        """The collectives of ``cfg``'s ``kind`` step on meta shards (its
        attention the chunked path: the kernel runs on the card only, and
        the collectives do not depend on it)."""
        DR.lm_record(dataclasses.replace(cfg, attention_impl="flash_jnp"),
                     kind, b, s, meta4)
        return D.collective_counts()

    fsdp = {}
    f32 = dict(n_layers=2, activ_dtype=torch.float32,
               param_dtype=torch.float32, attention_impl="flash_pallas",
               sharding="fsdp")
    c1 = dataclasses.replace(C.get_config(LM_ARCH), **f32)
    b, s = MESH_CHECK_BATCH, MESH_CHECK_SEQ
    model = init_params(transformer.build_model(c1, dev), gen(0))
    mesh_ = lm_mesh(devs)
    cm = c1.with_mesh(mesh_)
    mm = MeshModel(cm, mesh_, model)
    toks = torch.randint(0, c1.vocab, (b, s), device=dev, generator=gen(1))
    want_l, _ = transformer.prefill(c1, model, {"tokens": toks}, s + 8)
    zero_counts()
    D.reset_collectives()
    got_l, _ = transformer.prefill(cm, mm, {"tokens": toks}, s + 8)
    coll = D.collective_counts()
    launches = fa.flash_attention_fwd.launches
    check(launches == c1.n_layers * n_shards, f"fsdp f32 prefill: "
          f"{launches} flash launches, not {c1.n_layers * n_shards}")
    want_coll = predicted(c1, "prefill", b, s)
    check(coll == want_coll, f"fsdp f32 prefill collectives {coll}, not "
          f"{want_coll}")
    fsdp["f32_prefill_logits"] = held(
        got_l, want_l, LM_WHOLE_PATH_TOL, f"fsdp {LM_ARCH} f32 depth 2 "
        f"B{b} S{s}: last-position logits, (2, 2) vs unsharded")
    batch = {"tokens": toks, "labels": toks}
    ocfg = opt.OptConfig(lr=TRAIN_CHECK_LR, warmup=1, total_steps=1,
                         schedule=c1.schedule)
    _, _, m_want = make_train_step(c1, ocfg)(model, opt.init_state(model),
                                             batch)
    _, _, m_got = make_train_step(cm, ocfg)(mm, opt.init_state(mm), batch)
    loss_err = abs(float(m_got["loss"]) - float(m_want["loss"]))
    check(loss_err < TRAIN_LOSS_TOL, f"fsdp f32 loss {float(m_got['loss'])}"
          f" vs {float(m_want['loss'])}")
    got_p = mm.state_dict(dev)
    perr = max(float((got_p[n] - p.detach()).abs().max())
               for n, p in model.named_parameters())
    check(perr < TRAIN_PARAM_TOL, f"fsdp f32 params after one AdamW step: "
          f"{perr:.3e}")
    fsdp.update(f32_loss_err=loss_err, f32_param_err=perr)
    print(f"[check] fsdp {LM_ARCH} f32 depth 2 B{b} S{s} train step: loss "
          f"|err| {loss_err:.3e} (< {TRAIN_LOSS_TOL:g}); parameters after "
          f"one AdamW step max|err| {perr:.3e} (< {TRAIN_PARAM_TOL:g})",
          flush=True)
    del model, mm, got_p, want_l, got_l
    torch.cuda.empty_cache()
    # bf16 at full width: prefill and train steps, counted
    cfg = dataclasses.replace(C.get_config(LM_ARCH),
                              attention_impl="flash_pallas", sharding="fsdp")
    cm = cfg.with_mesh(mesh_)
    torch.cuda.reset_peak_memory_stats(dev)
    mm = MeshModel(cm, mesh_, init_params(transformer.build_model(cm, dev),
                                          gen(0)))
    prompt = {"tokens": torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                                      generator=gen(1), device=dev)}
    transformer.prefill(cm, mm, prompt, LM_PROMPT + 8)      # warm-up
    zero_counts()
    D.reset_collectives()
    with Timer(dev) as t:
        transformer.prefill(cm, mm, prompt, LM_PROMPT + 8)
    coll = D.collective_counts()
    launches = fa.flash_attention_fwd.launches
    want = cfg.n_layers * n_shards
    check(launches == want, f"fsdp prefill: {launches} flash launches, "
          f"not {want}")
    want_coll = predicted(cfg, "prefill", LM_BATCH, LM_PROMPT)
    check(coll == want_coll, f"fsdp prefill collectives {coll}, not "
          f"{want_coll}")
    counts["flash_attention"][LM_ARCH + " fsdp prefill"] = launches
    fsdp.update(prefill_ms=t.ms, prefill_collectives=coll,
                prefill_launches=launches)
    ocfg = opt.OptConfig(schedule=cfg.schedule)
    state = opt.init_state(mm)
    step = make_train_step(cm, ocfg)
    tb = {"tokens": prompt["tokens"], "labels": prompt["tokens"]}
    step(mm, state, tb)                                      # warm-up
    zero_counts()
    D.reset_collectives()
    with Timer(dev) as t:
        _, state, metrics = step(mm, state, tb)
    coll = D.collective_counts()
    fwd = fa.flash_attention_fwd.launches
    dq_n = fa.flash_attention_bwd_dq.launches
    dkdv_n = fa.flash_attention_bwd_dkdv.launches
    per = cfg.n_layers * n_shards
    check((fwd, dq_n, dkdv_n) == (2 * per, per, per), f"fsdp train step "
          f"launched ({fwd}, {dq_n}, {dkdv_n}), not ({2 * per}, {per}, "
          f"{per})")
    # the collectives do not depend on the sequence under fsdp (no split
    # head, one loss psum): predicted on meta shards at 1024 positions
    want_coll = predicted(cfg, "train", LM_BATCH, 1024)
    check(coll == want_coll, f"fsdp train collectives {coll}, not "
          f"{want_coll}")
    check(math.isfinite(float(metrics["loss"])), "fsdp train loss")
    counts["flash_attention"][LM_ARCH + " fsdp train"] = fwd
    counts["flash_attention_bwd"][LM_ARCH + " fsdp train"] = dkdv_n
    fsdp.update(step_ms=t.ms, step_tokens=LM_BATCH * LM_PROMPT,
                step_collectives=coll, step_launches=[fwd, dq_n, dkdv_n],
                loss=float(metrics["loss"]),
                peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    rows["fsdp"] = dict(fsdp, arch=LM_ARCH, mesh=list(MESH_SHAPE),
                        batch=LM_BATCH, seq=LM_PROMPT, dtype="bfloat16",
                        card=smi)
    print("[dryrun fsdp] " + json.dumps(rows["fsdp"]), flush=True)
    del mm, state, step, prompt, tb
    torch.cuda.empty_cache()

    # ---- the dry run's record against the card's run ----------------------
    cfg = C.get_config(LM_ARCH)          # flash_jnp: the dry run's attention
    rec = DR.lm_record(cfg, "prefill", LM_BATCH, LM_PROMPT, meta4)
    meta_coll = D.collective_counts()
    cm = cfg.with_mesh(mesh_)
    mm = MeshModel(cm, mesh_, init_params(transformer.build_model(cm, dev),
                                          gen(0)))
    prompt = {"tokens": torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                                      generator=gen(1), device=dev)}
    arg_bytes = (sum(p.numel() * p.element_size()
                     for p in mm.shards.flat[0].parameters())
                 + LM_BATCH // MESH_SHAPE[0] * LM_PROMPT * 4)
    check(rec["memory"]["argument_bytes"] == arg_bytes, f"dry run argument "
          f"bytes {rec['memory']['argument_bytes']}, the card's shard and "
          f"rows {arg_bytes}")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    D.reset_collectives()
    with FlopCounterMode(display=False) as fc:
        logits, _ = transformer.prefill(cm, mm, prompt, LM_PROMPT)
    torch.cuda.synchronize()
    card_flops = fc.get_total_flops()
    card_coll = D.collective_counts()
    peak = torch.cuda.max_memory_allocated(dev) - base
    check(bool(torch.isfinite(logits).all()), "dry-run check logits")
    check(card_flops == rec["hlo"]["dot_flops"] * n_shards, f"dry run "
          f"dot_flops {rec['hlo']['dot_flops']} × {n_shards} shards, "
          f"FlopCounterMode on the card {card_flops}")
    check(card_coll == meta_coll == mesh_prefill_collectives(cfg, devs),
          f"collectives: card {card_coll}, dry run {meta_coll}, the mesh "
          f"phase's {mesh_prefill_collectives(cfg, devs)}")
    rows["record"] = dict(
        arch=LM_ARCH, kind="prefill", mesh=list(MESH_SHAPE), batch=LM_BATCH,
        seq=LM_PROMPT, argument_bytes=arg_bytes,
        dot_flops_per_device=rec["hlo"]["dot_flops"],
        card_flop_counter_total=card_flops, collectives=card_coll,
        peak_per_device=rec["memory"]["peak_per_device"],
        card_peak_above_arguments=peak,
        ratio_dry_run_peak_to_card=rec["memory"]["peak_per_device"]
        * n_shards / (peak + n_shards * arg_bytes),
        dry_run_s=rec["compile_s"], useful_flops_ratio=rec[
            "useful_flops_ratio"], terms=rec["terms"], card=smi)
    print("[dryrun record] " + json.dumps(rows["record"]), flush=True)
    del mm, prompt, logits
    torch.cuda.empty_cache()

    # ---- the stencil-suite record's exchanges against run_sharded ---------
    srec = DR.run_stencil_cell(name2, meta4)
    dom = tuple(srec["domain"])
    check(dom == spec2.domain, f"stencil-suite {name2} domain {dom}")
    prog = compile_stencil(spec2, dom, t=srec["t_block"], mesh=
                           make_stencil_mesh(MESH_SHAPE, devices=devs))
    x = init_domain(spec2, dom, seed=0, device=dev)
    zero_counts()
    y = prog.run_sharded(x, srec["t_total"])
    torch.cuda.synchronize()
    calls = D.ppermute.calls
    want_calls = srec["hlo"]["coll_count"]["collective-permute"]
    check(calls == want_calls, f"run_sharded made {calls} exchanges, the "
          f"dry run counts {want_calls}")
    check(bool(torch.isfinite(y).all()), "stencil-suite run_sharded")
    rows["stencil_suite"] = dict(stencil=name2, domain=list(dom),
                                 t_block=srec["t_block"],
                                 t_total=srec["t_total"],
                                 collective_permute=want_calls,
                                 ppermute_calls=calls, card=smi)
    print("[dryrun stencil-suite] " + json.dumps(rows["stencil_suite"]),
          flush=True)
    del prog, x, y
    torch.cuda.empty_cache()
    print("[dryrun] " + json.dumps(dict(launches=counts, card=smi)),
          flush=True)
    for e in entries:
        if e["name"] in ("stencil2d", "stencil3d"):
            e["launches_shims"] = counts[e["name"]]
        elif e["name"] in counts:
            e["launches_fsdp"] = counts[e["name"]]


if __name__ == "__main__":
    sys.exit(main())
