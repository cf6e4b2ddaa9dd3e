#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the Metronome repro on one GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

It imports only ``repro_torch`` (from ``src/``), ``torch`` and ``numpy``,
builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` into
``build/kernels/``, and runs these phases on ``cuda:0``, each printing one
JSON line with its numbers and seconds:

  device        the card's name, count and ``nvidia-smi`` power limit
  build         one ``nvcc`` per kernel source, all started together
  trace_corpus  the 10,000-job production trace cut into 1024 active-set
                snapshots, filled by ``fluid.fill_corpus(backend='kernel')``
                and held against the float64 ``fill_python`` oracle
  experiment    ``experiment.run`` end to end on a production trace on the
                2-leaf x 2-host 2:1 leaf-spine fabric, fluid fill on the card,
                sampled in-loop solves held against ``fill_python``
  paper_grid    the paper's evaluation grid through ``experiment.sweep``
                with the fill on the card, at the reference benches'
                settings: every scheduler of the registry (Metronome,
                Default, Diktyo, Exclusive) and the ideal run on the
                snapshots S1-S5, F2, F4, J1; the ablations on S1-S5; the
                dynamic D1, D2 at three amplitudes; the fault R1, R2; the
                Fig. 10 trace; each cell run again on the CPU (the fill's
                plain version), whose results JSON must equal the card's;
                then the production trace under four schedulers (no CPU
                twin).  Every card cell's in-loop solves held against
                ``fill_python``; one line a cell, and a summary of the
                benches' derived numbers (printed, not gated)
  paper_figures the rest of the reference's evaluation the same way, 72
                cells, each twinned on the CPU: Fig. 11 (S1 with and
                without a mid-run 1.4x duty change on every job), Fig. 12
                (S4, S5 with the congested node's latency at 10, 40, 80
                ms), each under Metronome, Default and Diktyo; Fig. 14
                (S1-S3 under the controller's A_T x O_T thresholds);
                Fig. 15 (S3 at six WideResNet period gaps); Table VI
                (S1-S3, 150 s and 600 s windows); J1 joint against
                per-link rotation; the leaf-spine fabric at 1:1, 2:1,
                4:1 and F2, F4.  Then J1's worst planning score, the F4
                planner's per-link loop against ``joint_solve`` with the
                score kernel (host µs a call), and Fig. 16's placement
                and recalculation times (host time, no kernel); one line
                a cell, one for Fig. 16 and a summary under the benches'
                names (printed, not gated)
  robustness    the reference's graceful-degradation bench
                (``bench_robustness``) the same way: every control-plane
                read of bandwidth through a ``TelemetryChannel`` (1 s
                samples, noise, staleness) while the fluid fill keeps the
                truth, ``metronome`` against ``metronome-robust``
                (hysteresis 3 s / 5%, demand reconciliation) on four
                axes: noise on D1, D2 (0-0.4), staleness on D2 (0-10 s),
                R1's flapping uplink (0-8 cycles), noise on an 8-job
                Gavel-style trace (0, 0.2); seeds 3-5, 120 runs, each
                twinned on the CPU by a pool of spawned processes at a
                lower priority that runs beside the card side.  One line
                a run, one a seed-averaged point (the bench's 40 rows,
                held to ``validate_robustness_dict``), then the summary:
                each axis's curve and the failure axis's slope under each
                policy (printed, not gated)
  planner       J1 and F4 scheduled, then ``rotation.joint_solve`` and a
                candidate batch through ``joint_solve_batch`` with
                ``backend='kernel'`` held against ``backend='numpy'``
  lm_head       the LM head's three kernels (the float32 logits of bf16
                activations and head, and their two gradients) at the
                training cells' micro-batch shapes, InternLM2-20B's (4096,
                6144, 92544) and Mistral-7B's (4096, 4096, 32000): each
                one's largest error against a float64 product must be at
                most twice the float32 product's (cuBLAS, TF32 off); ms,
                device µs a launch, the bound (the product's operations,
                one pass) and the algorithm's floor (seven bf16 passes in
                all), TFLOP/s, and the float32 product's ms, the path the
                kernels replaced
  serve         RecurrentGemma-2B at full width (random weights from a
                seed, bf16) served by ``launch.serve.serve_requests``: 8
                requests in batches of 4, 4064-token prompts, 32 generated
                tokens; prefill through the flash-attention and RG-LRU
                kernels, decode steps reported to the stop-and-wait
                controller; ``forward`` held against prefill's logits
  train         RecurrentGemma-2B at full width and depth trained by
                ``build_train_step`` (random weights from a seed, bf16,
                float32 AdamW moments, remat on): 2 x 4096-token sequences
                of ``SyntheticLM`` a step in 2 micro-batches, one warm-up
                and 4 timed steps through ``CommGate`` and
                ``IterationReporter``; every parameter leaf must get a
                non-zero gradient, the warm-up step's loss change must be
                near its first-order prediction, the launch counts must
                match remat over every group and tail layer (the attention
                backward kernel once an attention layer a micro-batch), and
                4 steps on a repeated batch must lower its loss; one step
                under ``torch.profiler``, whose plain attention recompute
                (``attention_ref``'s (S, S) products) must read 0 ms
  train_dots    the train phase's state, model and traffic again under
                ``remat_policy="dots"`` (the outputs of the products
                without batch dims saved, the rest recomputed): the first
                micro-batch's loss and every gradient leaf must equal
                "nothing"'s bit for bit on the same parameters and batch,
                and the kernels must launch as often as under "nothing" a
                micro-batch and a step; a warm-up and 3 timed steps, the
                peak, one step under ``torch.profiler``
  serve_dense   the serve phase's traffic on Llama-3-8B at full width and
                depth (8.03 B parameters): prefill launches flash once a
                layer, decode runs the plain chunked attention, as the
                reference does
  train_dense   the train phase's steps and checks on Llama-3-8B at full
                width with its depth cut to 10 of 32 layers (one card holds
                no more state), flash launched 4 times a layer a step;
                then train_dense_dots, train_dots's checks and numbers on
                its state
  serve_moe     the dense serving traffic on Qwen1.5-MoE-A2.7B at full
                width and depth (14.32 B parameters): flash once a layer in
                prefill, the routed experts' dispatch, products and combine
                in plain PyTorch, as the reference computes them in XLA; the
                warm-up batch's prefill reports the share of expert
                assignments kept within capacity
  train_moe     the dense train phase's steps and checks on Qwen1.5-MoE at
                full width with its depth cut to 5 of 24 layers; also a
                finite, non-zero aux loss every step, and a gradient on
                each (layer, expert) slice exactly where the step-0 batch
                kept a token for that expert
  serve_xlstm   xLSTM-125M at full width and depth, 4096-token prompts (no
                kernel on this path); decode after prefill must continue
                the training forward
  serve_encdec  the Whisper-small backbone at full width and depth over
                1016 stub frames a request: flash bidirectional in each
                encoder layer and causal in each decoder layer of a prefill
  train_small   xLSTM-125M and Whisper-small trained at full width and
                depth, 3 timed steps each, the train phase's checks
  train_sharded train_dense's model, weights and batches for 2 steps on
                plain tensors and 2 on DTensor parameters over the 1 x 1
                ("data", "model") mesh of a world-size-1 NCCL group, through
                ``build_train_step(param_specs=...)``: losses and every
                parameter leaf bit for bit, flash launched as often (the
                kernels run on each rank's block); the same for the griffin
                smoke config, whose step runs the RG-LRU kernel and its
                backward on DTensor blocks, and its step under
                ``remat_policy="dots"`` plain and on DTensors, both bit
                for bit with "nothing"'s; step times both ways
  serve_sharded Llama-3-8B at full width and depth, one batch of 4 prompts
                of 4088 tokens and 8 generated tokens, on plain tensors
                and on DTensors over the 1 x 1 mesh (teacher-forced by the
                plain run's tokens): logits within 2e-2, prefill and decode
                times both ways, each after a warm-up at the same length,
                the median of 3 calls
  elastic       a failure after step 1 of the griffin smoke config:
                ``FaultTolerantRunner.on_failure`` with the one healthy rank
                plans and builds a (1, 1) mesh and restores the checkpoint;
                step 1 resumed on DTensors must equal the uninterrupted one
                bit for bit
  dryrun        ``launch.dryrun`` on a fake process group of 256 ranks
                (16 x 16), one process a cell, all started together at a
                lower priority beside train_dense and train_moe (host
                cores only; the card is 99% busy with the train steps):
                Llama-3-8B, Qwen1.5-MoE and RecurrentGemma-2B at train_4k,
                per-rank FLOPs, bytes, collectives, roofline terms with the
                H100's constants and the Metronome traffic each gives
  kernels       each kernel wrapper against its plain PyTorch version on the
                very inputs the paths above gave it, plus synthetic cases
                (padding, a wide candidate batch, a zero-capacity link whose
                scores must be NaN where the plain version's are,
                float32/bf16, causal, windowed, bidirectional and ragged
                attention at head dims 64/128/256, ragged RG-LRU shapes,
                the RG-LRU backward at the training shape and a ragged
                one, the attention backward at every mask, head dim and
                group size); the fill and the RG-LRU backward must match
                bit for bit, the attention backward its plain twin (and
                autograd through ``attention_ref``, the recompute it
                replaces) at the flash bars and two of its calls bit for
                bit, each training forward's lse the plain one's, and each
                main-path backward must take less device time than that
                recompute; in bf16 also under 1.5x the device time of the
                library's backward (below) at head dims 128 and 64, and at
                most 1.0x at the griffin model's D=256 window.  CUDA-event
                times around the wrappers, device-only times per launch
                (``torch.profiler``) of the fill and score kernels and of
                the main paths' flash and RG-LRU launches, bounds and the
                library's time: ``torch.cdist`` for the score, the backward
                alone of ``scaled_dot_product_attention`` for the attention
                backward, and for the forward
                ``scaled_dot_product_attention``, which the bf16
                flash kernel must beat at the serving shape and take no
                more than 1.25x of, in device time, at the Llama-3-8B,
                Qwen1.5-MoE and Whisper decoder main-path launches (head
                dims 128 and 64); the summary line gives each main-path
                flash case's ratio to the library and its bound's share
                of its device time

The phases run in this order but for serve_moe, which runs before
train_dense, and dryrun, whose cells run beside train_dense and train_moe.
Launch counts are zeroed just before each path and read just after it.
Every check that fails raises, so the script exits non-zero; it also exits
non-zero without a CUDA device.  The last lines are the kernel summary, the
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.

    python3 chip_smoke.py --lm-head

runs the device, build and lm_head phases alone.

    python3 chip_smoke.py --compare-flash OTHER/flash_attention.cu

runs none of the phases: it builds another ``flash_attention.cu`` (a parent
commit's, say) beside this checkout's and prints, for each D=128 and D=64
main-path shape, both kernels' device time a launch in the order other,
this, this, other, the library's before and after, and the bound.

    python3 chip_smoke.py --compare-rg-lru OTHER/rg_lru.cu

does the same for the RG-LRU backward: another ``rg_lru.cu`` built beside
this checkout's, both held bit for bit to the plain reverse loop at the
training shape (1, 4096, 2560), a ragged (2, 1001, 1000) and the griffin
smoke config's (2, 256, 64), their device time a launch in the order other,
this, this, other, the bound, and each build's ptxas registers.

    python3 chip_smoke.py --compare-flash-bwd OTHER/flash_attention_bwd.cu

does the same for the attention backward: another ``flash_attention_bwd.cu``
(a parent commit's, or a variant of this one) built beside this
checkout's, both held to the plain twin at the bf16 bars and two calls bit
for bit, at each bf16 main-path training shape (griffin, Llama-3-8B,
Qwen1.5-MoE, Whisper's encoder and decoder), their device time a launch
in the order other, this, this, other, the library's backward before and
after, the bound and each build's ptxas; it fails, once every shape is
printed, where this checkout's kernel is not the faster.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import math
import multiprocessing
import os
import pickle
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import _cuda_build  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch import configs as model_configs  # noqa: E402
from repro_torch.configs.metronome_testbed import (  # noqa: E402
    DYNAMIC_SNAPSHOTS, FABRIC_SNAPSHOTS, FAULT_SNAPSHOTS, JOINT_SNAPSHOTS,
    MODEL_FLEET, SNAPSHOTS, dynamic_scenario, fault_scenario, make_snapshot,
    snapshot_scenario, trace_scenario)
from repro_torch.core import events as events_mod  # noqa: E402
from repro_torch.core import experiment as experiment_mod  # noqa: E402
from repro_torch.core import fluid, geometry, rotation, scoring  # noqa: E402
from repro_torch.core.baselines import (DefaultPlugin,  # noqa: E402
                                        DiktyoPlugin)
from repro_torch.core.cluster import (Cluster, Node, Resources,  # noqa: E402
                                      make_fabric_cluster)
from repro_torch.core.contention import LinkView  # noqa: E402
from repro_torch.core.controller import StopAndWaitController  # noqa: E402
from repro_torch.core.experiment import (Policy, Scenario,  # noqa: E402
                                         run, sweep)
from repro_torch.core.results import (ExperimentResult,  # noqa: E402
                                      SweepCell, SweepResult,
                                      to_robustness_dict,
                                      validate_robustness_dict)
from repro_torch.core.framework import SchedulingFramework  # noqa: E402
from repro_torch.core.scheduler import MetronomePlugin  # noqa: E402
from repro_torch.core.simulator import SimConfig  # noqa: E402
from repro_torch.core.telemetry import TelemetryChannel  # noqa: E402
from repro_torch.core.topology import is_uplink, uplink_id  # noqa: E402
from repro_torch.core.trace import (TraceJobSpec,  # noqa: E402
                                    active_jobs_at, cluster_load,
                                    generate_production_trace,
                                    generate_trace,
                                    trace_departure_events, trace_job_name,
                                    trace_to_jobs)
from repro_torch.core.workload import Workload, make_job  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    _bwd_head_split, _flash_attention_bwd, flash_attention_fwd)
from repro_torch.kernels.lm_head import (_lm_head_dw,  # noqa: E402
                                         _lm_head_dx, _lm_head_fwd)
from repro_torch.kernels.metronome_fill import metronome_fill  # noqa: E402
from repro_torch.kernels.metronome_score import (  # noqa: E402
    metronome_score_multilink, metronome_score_multilink_batch,
    metronome_score_pairwise)
from repro_torch.kernels.rg_lru import (_rg_lru_pallas_bwd,  # noqa: E402
                                        rg_lru_pallas)
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.serve import (make_frames,  # noqa: E402
                                      make_prompts, serve_requests)
from repro_torch.models import (decode_step, forward,  # noqa: E402
                                init_model, logical_specs, loss_fn,
                                param_count, prefill)
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.runtime.comm_gate import (CommGate,  # noqa: E402
                                           IterationReporter)
from repro_torch.runtime.elastic import FaultTolerantRunner  # noqa: E402
from repro_torch.runtime.steps import (TrainState,  # noqa: E402
                                       build_train_step, init_train_state)
from repro_torch.sharding import shard_tree, use_rules  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 989e12  # dense, tensor cores

DEVICE = "cuda"

FILL_TOL = 1e-4     # the padded case's rates vs their exact values
# (the fill kernel itself is held to its plain version bit for bit)
SCORE_TOL = 1e-4
ORACLE_TOL = 1e-6   # float32 fill vs the float64 fill_python oracle
# flash attention (TestFlashAttention), RG-LRU (TestRgLruKernel), and
# forward vs prefill logits in bf16 (tests/test_models.py)
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
RG_LRU_TOL = 1e-4
LOGIT_TOL = 2e-2

# bf16 flash, normwise: ||got - want|| / ||want|| over the whole output.
# Sound kernels read ~2e-3 (bf16 rounding of P and of both outputs); a
# dropped k tile or a window edge moved in by 8 keys reads 2e-2 or more.
# It catches a fault spread thinly over many small outputs (deep in the
# window they are ~0.03), which the elementwise 2e-2 is too loose to see.
FLASH_NORM_TOL = 5e-3
# the attention backward against its plain twin (the same o and lse), per
# gradient: 1e-4 abs+rel elementwise in float32 (tiled sums), the flash
# bars in bf16 (P and dS rounded to bf16 for the tensor cores); the
# training forward's lse against the plain one's, abs+rel
FLASH_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LSE_TOL = 1e-5

# the bf16 flash kernel at D=128 and D=64 on the main paths: no slower than
# this many times scaled_dot_product_attention on the same inputs, each in
# device time under torch.profiler (the CUDA-event ms around a call also
# holds 40-70 us of host work, which moves between runs)
FLASH_FLOOR = 1.25
# the bf16 attention backward on the main paths, in device time against
# the library's backward alone on the same inputs: under this many times
# it at head dims 128 and 64, at most this many at the griffin model's
# D=256 window (whose library call takes a mask and no flash kernel)
FLASH_BWD_FLOOR = {64: 1.5, 128: 1.5, 256: 1.0}
FLASH_FLOOR_CASES = ("flash_serve_dense", "flash_train_dense",
                     "flash_serve_sharded", "flash_serve_moe",
                     "flash_train_moe", "flash_serve_encdec_decoder",
                     "flash_train_small_decoder")

# each redesigned kernel's design and the ptxas entries whose registers and
# spills the summary reports
REDESIGNED = {
    "metronome_fill": dict(
        design="water level per problem, route and saturation bitmasks, "
               "link counts decremented at freeze; one warp per problem "
               "for F, L <= 32, else one CTA with two barriers a round",
        ptxas_entries=("fill_warp_kernel", "fill_block_kernelILb1E",
                       "fill_block_kernelILb0E")),
    "metronome_score": dict(
        design="24x24 (a, b) tile a block, 3x3 micro-tile a thread, "
               "base+A and B-cap staged by 16-byte loads, links split "
               "over up to 4 thread groups, NaN-propagating max",
        ptxas_entries=("score_kernelILi72E", "score_kernelILi0E")),
    "flash_attention_fwd": dict(
        design={"bfloat16 D=256": "wgmma+tma: 2 warpgroups, 64-key tiles, "
                                  "2-stage TMA ring fed by thread 0",
                "bfloat16 D<=128": "wgmma+tma: a producer warpgroup, "
                                   "128-key tiles, 2 consumer warpgroups "
                                   "each issuing tile i's S with tile "
                                   "i-1's P.V and running tile i's "
                                   "softmax under that P.V, taking turns "
                                   "to issue; P through shared memory "
                                   "(stmatrix) at D=128, in registers at "
                                   "D=64",
                "float32": "CUDA-core FMAs"},
        # serving (Lb0E) and training (Lb1E: lse written) instantiations
        ptxas_entries=tuple(f"{k}ELb{b}E" for b in (0, 1) for k in (
            "flash_fwd_bf16ILi256", "flash_fwd_bf16_wsILi128",
            "flash_fwd_bf16_wsILi64"))),
    "rg_lru_pallas": dict(
        design="one warp per 32 columns, 3-stage cp.async ring",
        ptxas_entries=("rg_lru_kernel",)),
    "_rg_lru_pallas_bwd": dict(
        design="the adjoint walked from the last step, 16 columns a block "
               "(160 blocks at B=1, W=2560): a memory warp loads 64-step "
               "TMA boxes of g, a shifted +1 and y shifted -1 into a "
               "4-stage mbarrier ring (48 KB), writes da = d * y_prev and "
               "stores dx and da by TMA; a walker warp, one lane a column, "
               "runs only the chain, d written over g in shared memory; "
               "4-byte cp.async copies where W % 4 or a base is off 16 bytes",
        ptxas_entries=("rg_lru_bwd_kernel",)),
    "_flash_attention_bwd": dict(
        design={"bfloat16": "wgmma+tma: 256 threads, two consumer "
                            "warpgroups, thread 0 producing; row "
                            "statistics (lse*log2e, delta) padded, then a "
                            "dK/dV kernel (128 keys a block, 64 a "
                            "warpgroup; 64 keys at D=256, D split over the "
                            "warpgroups) streaming 64-row q, dO and row "
                            "statistics through a 2-4 stage full/empty "
                            "mbarrier ring, S^T = K Q^T and dP^T = V dO^T "
                            "so P^T and dS^T are wgmma's register A "
                            "operands of dV and dK; a dQ kernel (128 q rows "
                            "a block) streaming k and v; where the key "
                            "tiles leave SMs idle, each group's q heads "
                            "split over blocks and their float32 partials "
                            "summed in head order; no atomics",
                "float32": "CUDA cores, 32 x 32 tiles"},
        ptxas_entries=tuple(f"flash_bwd_bf16_{p}ILi{d}E"
                            for p in ("dkdv", "dq") for d in (64, 128, 256))
        + tuple(f"flash_bwd_f32ILi{d}ELb{b}E"
                for d in (64, 128, 256) for b in (0, 1))
        + tuple(f"bwd_rowstats_bf16ILi{d}E" for d in (64, 128, 256))
        + ("bwd_reduce_dkv",)),
}

# substrings of each kernel's name in a profiler trace
FILL_KERNELS = ("fill_warp_kernel", "fill_block_kernel")
SCORE_KERNELS = ("score_kernel",)
FLASH_KERNELS = ("flash_fwd_",)
# the attention backward's kernels: float32 runs three a call (bwd_delta,
# dK/dV, dQ), bf16 three (bwd_rowstats, dK/dV, dQ) or, where it splits the
# group's q heads, four (bwd_reduce too): flash_bwd_kernels gives the count
FLASH_BWD_KERNELS = ("flash_bwd_", "bwd_delta", "bwd_rowstats", "bwd_reduce")
LM_HEAD_KERNELS = ("lm_head_gemm",)

SCORE_WRAPPERS = (metronome_score_multilink_batch, metronome_score_multilink,
                  metronome_score_pairwise)
LM_HEAD_WRAPPERS = (_lm_head_fwd, _lm_head_dx, _lm_head_dw)
MODEL_WRAPPERS = (flash_attention_fwd, _flash_attention_bwd, rg_lru_pallas,
                  _rg_lru_pallas_bwd) + LM_HEAD_WRAPPERS
ALL_WRAPPERS = (metronome_fill,) + SCORE_WRAPPERS + MODEL_WRAPPERS


# the training traffic: full-width RecurrentGemma-2B, train_4k's sequence
# length, 2 sequences a step in 2 micro-batches (gradient accumulation),
# the reference's AdamW defaults (the warm-up step runs at 3e-6, 1/100 of
# 3e-4).  The loss check repeats the step-0 batch with no warm-up at 3e-5:
# the first step's witness (first_step_witness) measures how far past
# first order a no-warm-up step at the defaults' 3e-4 would be (PERF.md,
# Findings)
TRAIN = dict(arch="recurrentgemma-2b", seq=4096, batch=2, n_micro=2,
             steps=4, seed=0, check_lr=3e-5)
# the same traffic on Llama-3-8B at full width, its depth cut from 32 to
# 10 layers: 3.23 B parameters, 45.3 GB of bf16 weights, float32 moments
# and float32 accumulator, which leaves one card room for a micro-batch's
# gradients, the float32 logits and the attention recompute (PERF.md).
# The loss check runs at 3e-6, where the warm-up step's witness held its
# loss change to 0.99 of first order; a no-warm-up step at 3e-5 is ~60x
# past it here (lr x ||g||_1 = 64 nats) and the repeated batch's loss
# rose from 8.66 to 12.56 before it fell (PERF.md, Findings)
TRAIN_DENSE = dict(TRAIN, arch="llama3-8b", n_layers=10, check_lr=3e-6)
# the train and train_dense phases' state, model and traffic again under
# remat_policy="dots" (the reference's dots_with_no_batch_dims_saveable):
# the first micro-batch's gradients against "nothing"'s, a warm-up and
# DOTS_STEPS timed steps, one profiled
DOTS_PHASES = ("train", "train_dense")
DOTS_STEPS = 3
# the warm-up step's loss change on its batch over its first-order
# prediction g . (p1 - p0): a gradient wrong on much of the model, or a
# step too long for first order, moves it far off 1
FIRST_STEP_RATIO = (0.5, 1.5)

# the serving traffic: full-width RecurrentGemma-2B, max_len 4096 (a
# multiple of attn_chunk, so repro.launch.serve could serve the same), prompts
# longer than the 2048-token window
# (a warm-up batch generates ``warmup_gen`` tokens, the profiled batch
# ``profile_gen``)
SERVE = dict(arch="recurrentgemma-2b", requests=8, batch=4, prompt_len=4064,
             gen=32, seed=0, warmup_gen=2, profile_gen=8)
# the same traffic on Llama-3-8B at full width and depth: 8.03 B
# parameters (16.1 GB in bf16), a 2.1 GB KV cache a batch.  Its decode
# attends over the whole cache by chunks of attn_chunk (1024) tokens, as
# the reference's does, so prompt plus generated tokens must fill whole
# chunks: the warm-up and profiled batches generate all 32 tokens too
SERVE_DENSE = dict(SERVE, arch="llama3-8b", warmup_gen=32, profile_gen=32)
# Qwen1.5-MoE-A2.7B at full width and depth (14.32 B parameters, 28.6 GB
# in bf16), the dense serving traffic; the warm-up batch's prefill reports
# the share of expert assignments kept within capacity (factor 1.25)
SERVE_MOE = dict(SERVE_DENSE, arch="qwen2-moe-a2.7b")
# the same model trained at full width, its depth cut to the most layers
# that leave 8 GB of the card's 80 free at the reckoned peak (PERF.md):
# 5 of 24, 3.47 B parameters, 48.6 GB of state; the dense loss check's lr
TRAIN_MOE = dict(TRAIN_DENSE, arch="qwen2-moe-a2.7b", n_layers=5)
# xLSTM-125M at full width and depth: prompts of 4096 tokens, whole chunks
# of the mLSTM's 256 (no Pallas kernel on this path); decode after a
# prefill of 3840 tokens must continue forward over 8 teacher-forced steps
SERVE_XLSTM = dict(SERVE, arch="xlstm-125m", prompt_len=4096,
                   decode_check=8)
# the Whisper-small backbone at full width and depth, the dense serving
# traffic with 4064 // 4 = 1016 stub frames a request: flash bidirectional
# in the encoder, causal in the decoder
SERVE_ENCDEC = dict(SERVE_DENSE, arch="whisper-small")
# xLSTM-125M and Whisper-small trained at full width and depth: 3 timed
# steps of the train traffic (Whisper's batch with 1024 frames a sequence);
# the loss check at the griffin's 3e-5 (an Adam step's first-order gain
# lr x ||g||_1 is ~2-8 nats there)
TRAIN_SMALL = [dict(TRAIN, arch=arch, steps=3)
               for arch in ("xlstm-125m", "whisper-small")]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# workloads (the port's copies of the reference benches' scenario builders)
# ---------------------------------------------------------------------------

# bench_trace_throughput: dumbbell fabric, 2 racks x 4 tiered-NIC hosts
NIC_TIERS = (1.0, 2.5, 10.0, 40.0)
PLACE_WEIGHTS = (0.08, 0.12, 0.30, 0.50)
TRUNK_GBPS = 10.0
CROSS_RACK_MOD = 10


def _pick_host(h: int) -> int:
    x = (h * 2654435761 % 2**32) / 2**32
    acc = 0.0
    for k, w in enumerate(PLACE_WEIGHTS):
        acc += w
        if x < acc:
            return k
    return len(PLACE_WEIGHTS) - 1


def snapshot_problem(trace: Sequence[TraceJobSpec], t_s: float):
    """The fill problem of the trace's active set at ``t_s``: each task on
    a weighted-hash host of its job's rack, cross-rack jobs over the trunk."""
    demands: List[float] = []
    paths: List[Tuple[str, ...]] = []
    for ji in active_jobs_at(trace, t_s):
        spec = trace[ji]
        bw = float(MODEL_FLEET[spec.model]["bw_gbps"])
        cross = (ji % CROSS_RACK_MOD == 0)
        for k in range(spec.n_tasks):
            rack = (ji + (k % 2 if cross else 0)) % 2
            host = f"h{rack}{_pick_host(ji * 31 + k)}"
            paths.append((host, "trunk") if cross else (host,))
            demands.append(bw)
    caps = {f"h{r}{k}": NIC_TIERS[k] for r in range(2)
            for k in range(len(NIC_TIERS))}
    caps["trunk"] = TRUNK_GBPS
    return demands, paths, caps


# bench_dynamic_throughput: 2 leaves x 2 hosts at 25 Gbps, 2:1 uplinks
N_LEAVES = 2
HOSTS_PER_LEAF = 2
OVERSUBSCRIPTION = 2.0
TRACE_KW = dict(median_duration_s=20.0, duration_sigma=1.0,
                duration_clip_s=(8.0, 80.0), task_multipliers=(1, 2),
                task_weights=(0.85, 0.15))
TIME_SCALE = 0.06
N_EVENT_BURSTS = 24


def synthetic_events(trace: Sequence[TraceJobSpec],
                     horizon_ms: float) -> List[events_mod.Event]:
    """Background ramps, uplink capacity dips and traffic changes across
    the run, plus unknown-target events that are warned about and dropped."""
    evs: List[events_mod.Event] = []
    hosts = [f"leaf{k}-host0" for k in range(min(4, N_LEAVES))]
    uplink = uplink_id("leaf0")
    for b in range(N_EVENT_BURSTS):
        t0 = horizon_ms * (b + 0.25) / N_EVENT_BURSTS
        t1 = horizon_ms * (b + 0.75) / N_EVENT_BURSTS
        host = hosts[b % len(hosts)]
        evs.append(events_mod.BackgroundFlowChange(t0, link=host,
                                                   rate_gbps=8.0))
        evs.append(events_mod.BackgroundFlowChange(t1, link=host,
                                                   rate_gbps=0.0))
        if b % 3 == 0:
            evs.append(events_mod.LinkCapacityChange(
                t0, link=uplink, allocatable_gbps=0.6 * HOSTS_PER_LEAF
                * 25.0 / OVERSUBSCRIPTION))
            evs.append(events_mod.LinkCapacityChange(
                t1, link=uplink, allocatable_gbps=None,
                capacity_gbps=HOSTS_PER_LEAF * 25.0 / OVERSUBSCRIPTION))
        if b % 4 == 0 and trace:
            ji = (b * 37) % len(trace)
            evs.append(events_mod.TrafficChange(
                t0, job=trace_job_name(trace[ji], ji),
                duty_mult=1.25 if b % 8 else 0.8))
    evs.append(events_mod.BackgroundFlowChange(horizon_ms * 0.1,
                                               link="ghost-host",
                                               rate_gbps=5.0))
    evs.append(events_mod.BackgroundFlowChange(horizon_ms * 0.2,
                                               link="ghost-host",
                                               rate_gbps=9.0))
    evs.append(events_mod.TrafficChange(horizon_ms * 0.15, job="ghost-job",
                                        duty_mult=2.0))
    return evs


def horizon_ms(trace: Sequence[TraceJobSpec],
               time_scale: float = TIME_SCALE) -> float:
    return max(s.submit_time_s + s.duration_s for s in trace) \
        * time_scale * 1e3


@dataclasses.dataclass(frozen=True)
class DynamicTraceBuild:
    """Production trace + departures + synthetic events on the
    oversubscribed 2x2 leaf-spine fabric, as a trace ``Scenario.build``."""

    trace: Tuple[TraceJobSpec, ...]
    time_scale: float = TIME_SCALE

    def __call__(self):
        cluster = make_fabric_cluster(
            n_leaves=N_LEAVES, hosts_per_leaf=HOSTS_PER_LEAF,
            bw_gbps=25.0, oversubscription=OVERSUBSCRIPTION)
        jobs = trace_to_jobs(list(self.trace), MODEL_FLEET,
                             time_scale=self.time_scale, open_ended=True)
        wls = []
        for j in jobs:
            wl = Workload(name=j.name, jobs=[j])
            j.workload = wl.name
            for t in j.tasks:
                t.workload = wl.name
            wls.append(wl)
        events = list(trace_departure_events(list(self.trace),
                                             time_scale=self.time_scale))
        events.extend(synthetic_events(self.trace,
                                       horizon_ms(self.trace,
                                                  self.time_scale)))
        return cluster, wls, (), events


def dynamic_trace_scenario(trace: Sequence[TraceJobSpec]) -> Scenario:
    return Scenario.trace(name="dynamic-trace",
                          build=DynamicTraceBuild(tuple(trace)))


DYNAMIC_POLICY = Policy("metronome", skip_third_stage=True,
                        rotation_joint=False)


def dynamic_sim_kw(trace: Sequence[TraceJobSpec]) -> dict:
    return dict(duration_ms=horizon_ms(trace) + 1_000.0, seed=3,
                jitter_std=0.01)


def dynamic_sim_config(trace: Sequence[TraceJobSpec], **kw) -> SimConfig:
    return SimConfig(**dynamic_sim_kw(trace), **kw)


@contextlib.contextmanager
def audited_engines(stride: int = 7):
    """Every ``FluidEngine`` built inside keeps each ``stride``-th in-loop
    solve (demands, paths, caps, rates) for an offline oracle audit."""
    engines: List[fluid.FluidEngine] = []
    init = fluid.FluidEngine.__init__

    def audited_init(self, *a, **kw):
        init(self, *a, **kw)
        self.sample_stride = stride
        engines.append(self)

    fluid.FluidEngine.__init__ = audited_init
    try:
        yield engines
    finally:
        fluid.FluidEngine.__init__ = init


def audit_error(engine: fluid.FluidEngine) -> float:
    """Max abs difference of the engine's sampled solves from the float64
    ``fill_python`` oracle."""
    err = 0.0
    for d, p, c, r in engine.samples:
        gold = fluid.fill_python(np.asarray(d, dtype=float), p, c)
        if len(gold):
            err = max(err, float(np.max(np.abs(r - gold))))
    return err


# ---------------------------------------------------------------------------
# the paper's evaluation grid: the settings of the reference's benches
# (benchmarks/common.py, bench_snapshots, bench_ablation, bench_dynamic,
# bench_tct; the fault cells as tests/test_torch_robustness.py runs them),
# copied because they import the JAX package;
# tests/test_torch_paper_grid.py holds each to the bench's own value
# ---------------------------------------------------------------------------

PAPER_SCHEDULERS = ("metronome", "default", "diktyo", "exclusive", "ideal")
GRID_SNAPSHOTS = SNAPSHOTS + FABRIC_SNAPSHOTS + JOINT_SNAPSHOTS
BENCH_ITERATIONS = 400
BENCH_SIM = dict(duration_ms=150_000.0, seed=3, jitter_std=0.01)
ABLATIONS = (Policy("metronome", label="full"),
             Policy("metronome", skip_third_stage=True,
                    rotation_mode="compact", label="wo_stage3"))
ABLATION_SIM = dict(BENCH_SIM, jitter_std=0.02)
DYNAMIC_AMPLITUDES = (0.2, 0.3, 0.4)
DYNAMIC_SCENARIO_KW = dict(n_iterations=300, t_on_ms=15_000.0,
                           t_off_ms=45_000.0)
DYNAMIC_GRID_POLICIES = (
    Policy("metronome"),
    Policy("metronome", reconfigure=False, label="metronome_noreconf"),
    Policy("default"))
DYNAMIC_SIM = dict(duration_ms=120_000.0, seed=3, jitter_std=0.01)
FAULT_SCHEDULERS = ("metronome", "default", "diktyo", "exclusive")
FAULT_KW = dict(n_iterations=30, start_ms=3_000.0, period_ms=6_000.0,
                down_ms=1_000.0, n_cycles=2)
FAULT_SIM = dict(duration_ms=20_000.0, seed=3, jitter_std=0.01)
FIG10_TRACE_KW = dict(duration_s=1800, total_gpus=13, target_load=0.85,
                      seed=1, job_duration_range_s=(120, 240))
FIG10_JOBS = 10
FIG10_SCHEDULERS = ("metronome", "default", "diktyo")
FIG10_SIM = dict(duration_ms=1_200_000, seed=0, jitter_std=0.01)
# the production trace: no ideal run (one cluster copy a job) and no CPU
# twin (its cost); DYNAMIC_POLICY's run is the experiment phase's
PRODUCTION_POLICIES = tuple(Policy(s) for s in FAULT_SCHEDULERS)


@contextlib.contextmanager
def fleet_period(model: str, period_ms: float):
    """``MODEL_FLEET[model]``'s period set to ``period_ms`` inside (the
    entry itself restored after, as ``bench_thresholds``' Fig. 15 does)."""
    saved = MODEL_FLEET[model]
    MODEL_FLEET[model] = dict(saved, period_ms=period_ms)
    try:
        yield
    finally:
        MODEL_FLEET[model] = saved


@dataclasses.dataclass(frozen=True)
class Grid:
    """One ``sweep`` of the paper grid: its scenarios, policies and the
    ``SimConfig`` fields but for the backend and device (None where each
    scenario carries its own ``SimConfig``, as Table VI's do); ``twin``
    runs it again on the CPU (the fill's plain version) to compare;
    ``cut`` says how a cell was cut from its source."""

    name: str
    scenarios: Tuple[Scenario, ...]
    policies: Tuple[Policy, ...]
    sim: Optional[dict]
    twin: bool = True
    cut: Optional[str] = None

    def run(self, device: str) -> SweepResult:
        """The grid's sweep with the fill's kernel on ``device``, the one
        place a grid's backend and device are set: in ``sweep``'s config,
        or in each scenario's own ``SimConfig`` where ``sim`` is None, so
        the CPU twin of Table VI never runs on the card."""
        if self.sim is not None:
            return sweep(self.scenarios, self.policies, SimConfig(
                fluid_backend="kernel", device=device, **self.sim))
        return sweep(tuple(dataclasses.replace(
            s, sim_config=dataclasses.replace(
                s.sim_config, fluid_backend="kernel", device=device))
            for s in self.scenarios), self.policies, None)


def fig10_trace() -> List[TraceJobSpec]:
    return generate_trace(MODEL_FLEET, **FIG10_TRACE_KW)[:FIG10_JOBS]


def paper_grids(production: Sequence[TraceJobSpec]) -> List[Grid]:
    """The grids in the order they run; a dynamic scenario's name carries
    its amplitude, so one sweep holds every (snapshot, amplitude) cell."""
    fig10 = fig10_trace()
    return [
        Grid("snapshots", tuple(snapshot_scenario(
            sid, n_iterations=BENCH_ITERATIONS) for sid in GRID_SNAPSHOTS),
            tuple(Policy(s) for s in PAPER_SCHEDULERS), BENCH_SIM),
        Grid("ablations", tuple(snapshot_scenario(
            sid, n_iterations=BENCH_ITERATIONS) for sid in SNAPSHOTS),
            ABLATIONS, ABLATION_SIM),
        Grid("dynamic", tuple(dataclasses.replace(
            dynamic_scenario(sid, amplitude=amp, **DYNAMIC_SCENARIO_KW),
            name=f"{sid}-a{amp:g}") for sid in DYNAMIC_SNAPSHOTS
            for amp in DYNAMIC_AMPLITUDES), DYNAMIC_GRID_POLICIES,
            DYNAMIC_SIM),
        Grid("faults", tuple(fault_scenario(sid, **FAULT_KW)
                             for sid in FAULT_SNAPSHOTS),
             tuple(Policy(s) for s in FAULT_SCHEDULERS), FAULT_SIM),
        Grid("fig10", (trace_scenario(fig10, open_ended=True,
                                      name="gavel-trace"),),
             tuple(Policy(s) for s in FIG10_SCHEDULERS), FIG10_SIM),
        Grid("fig10_ideal", (trace_scenario(fig10, open_ended=False,
                                            name="gavel-trace-capped"),),
             (Policy("ideal"),), FIG10_SIM),
        Grid("production", (dynamic_trace_scenario(production),),
             PRODUCTION_POLICIES, dynamic_sim_kw(production), twin=False,
             cut=f"{len(production)} of the reference bench's 10,000 "
                 "jobs, for the run's time limit"),
    ]


@contextlib.contextmanager
def metered_runs(recs: Dict[str, "Recorder"],
                 engines: List[fluid.FluidEngine]):
    """Every ``experiment.run`` inside (``sweep`` runs each cell through
    it) records, by (scenario, policy, device): its wall seconds, fill
    launches, fill op calls and seconds (from ``recs[device]``, active
    around the run), and the fluid engines it built (``engines`` from
    :func:`audited_engines`)."""
    meters: Dict[Tuple[str, str, str], dict] = {}
    inner = experiment_mod.run

    def metered(scenario, policy, sim_config=None):
        device = (sim_config or scenario.sim_config).device
        key = (scenario.name, policy.name, device)
        check(key not in meters, f"two cells share the meter key {key}")
        rec = recs[device]
        launched = metronome_fill.launches
        calls = rec.n_calls("progressive_fill")
        fill_s, built = rec.seconds["progressive_fill"], len(engines)
        t0 = time.perf_counter()
        out = inner(scenario, policy, sim_config)
        meters[key] = dict(
            seconds=time.perf_counter() - t0,
            fill_launches=metronome_fill.launches - launched,
            fill_op_calls=rec.n_calls("progressive_fill") - calls,
            fill_op_seconds=rec.seconds["progressive_fill"] - fill_s,
            engines=engines[built:])
        return out

    experiment_mod.run = metered
    try:
        yield meters
    finally:
        experiment_mod.run = inner


def _finite(x: float) -> Optional[float]:
    """``x`` as a float, or None where it is NaN or infinite (a scenario
    without jobs of a priority class has no mean)."""
    x = float(x)
    return x if math.isfinite(x) else None


def cell_numbers(res: ExperimentResult) -> dict:
    """A cell's end-to-end numbers, split by priority as the benches do."""
    hi, lo = res.high_priority, res.low_priority
    sim = res.sim
    return dict(
        hi_s_per_1000=_finite(res.mean_s_per_1000(hi)),
        lo_s_per_1000=_finite(res.mean_s_per_1000(lo)),
        hi_jct_ms=_finite(res.mean_jct_ms(hi)),
        lo_jct_ms=_finite(res.mean_jct_ms(lo)),
        mean_jct_ms=_finite(res.mean_jct_ms()),
        total_completion_ms=_finite(sim.total_completion_ms),
        avg_bw_utilization=_finite(sim.avg_bw_utilization),
        readjustments=sim.readjustments,
        reconfigurations=sim.reconfigurations,
        accepted=len(res.accepted), pending=len(res.rejected))


def _pct(a: float, b: float) -> Optional[float]:
    """100 (1 - a / b), the benches' acceleration (None without a b)."""
    return _finite(100.0 * (1.0 - a / b)) if b else None


def _gap(a: float, b: float) -> Optional[float]:
    """100 (a / b - 1), the benches' gap and ablation delta."""
    return _finite(100.0 * (a / b - 1.0)) if b else None


def grid_summary(got: Dict[str, SweepResult]) -> dict:
    """The benches' derived numbers from the card's cells, printed, not
    gated: Fig. 8's acceleration of Metronome against Default and Diktyo
    per snapshot and priority, Table V's utilisation deltas (percentage
    points), the high-priority gap to the ideal run, Tables VII's
    ablation, the dynamic grid's JCT gain and reconfiguration saving, and
    Fig. 10's total completion time."""
    snaps = got["snapshots"]
    fig8, table5, ideal_gap = {}, {}, {}
    for sid in GRID_SNAPSHOTS:
        me = snaps.get(sid, "metronome")
        hi, lo = me.high_priority, me.low_priority
        fig8[sid] = {f"{cls}_vs_{other}": _pct(
            me.mean_s_per_1000(jobs), snaps.get(sid, other)
            .mean_s_per_1000(jobs))
            for other in ("default", "diktyo")
            for cls, jobs in (("hi", hi), ("lo", lo)) if jobs}
        table5[sid] = {other: _finite(100.0 * (
            me.sim.avg_bw_utilization
            - snaps.get(sid, other).sim.avg_bw_utilization))
            for other in ("default", "diktyo", "exclusive", "ideal")}
        if hi:
            ideal_gap[sid] = _gap(
                me.mean_s_per_1000(hi),
                snaps.get(sid, "ideal").mean_s_per_1000(hi))
    ablation = {}
    for sid in SNAPSHOTS:
        full = got["ablations"].get(sid, "full")
        var = got["ablations"].get(sid, "wo_stage3")
        ablation[sid] = dict(
            lo_pct=_gap(var.mean_s_per_1000(full.low_priority),
                        full.mean_s_per_1000(full.low_priority)),
            hi_pct=_gap(var.mean_s_per_1000(full.high_priority),
                        full.mean_s_per_1000(full.high_priority)),
            gamma_delta_pp=_finite(100.0 * (var.sim.avg_bw_utilization
                                            - full.sim.avg_bw_utilization)))
    dynamic = {}
    for scn in {c.scenario: None for c in got["dynamic"].cells}:
        me = got["dynamic"].get(scn, "metronome")
        noreconf = got["dynamic"].get(scn, "metronome_noreconf")
        dynamic[scn] = dict(
            jct_gain_vs_default_pct=_pct(
                me.mean_jct_ms(),
                got["dynamic"].get(scn, "default").mean_jct_ms()),
            reconf_lo_jct_saving_pct=_pct(
                me.mean_jct_ms(me.low_priority),
                noreconf.mean_jct_ms(noreconf.low_priority)))
    tct = {p: got["fig10"].get("gavel-trace", p).sim.total_completion_ms
           for p in FIG10_SCHEDULERS}
    tct["ideal"] = got["fig10_ideal"].get("gavel-trace-capped",
                                          "ideal").sim.total_completion_ms
    return dict(
        fig8_accel_pct=fig8, tableV_gamma_delta_pp=table5,
        hi_gap_to_ideal_pct=ideal_gap, tableVII_wo_stage3=ablation,
        dynamic=dynamic, fig10_tct_s={p: _finite(v / 1e3)
                                      for p, v in tct.items()},
        fig10_tct_gain_vs_default_pct=_pct(tct["metronome"],
                                           tct["default"]),
        fig10_tct_gap_to_ideal_pct=_gap(tct["metronome"], tct["ideal"]),
        fig10_load=cluster_load(fig10_trace(), FIG10_TRACE_KW["total_gpus"],
                                FIG10_TRACE_KW["duration_s"]))


# ---------------------------------------------------------------------------
# the rest of the paper's evaluation: the settings of the reference's
# bench_param_variation (Figs. 11, 12), bench_thresholds (Figs. 14, 15),
# bench_persistence (Table VI), bench_rotation (J1, the F4 planner),
# bench_fabric and bench_sched_time (Fig. 16), copied because they import
# the JAX package; tests/test_torch_paper_figures.py holds each to the
# bench's own value
# ---------------------------------------------------------------------------

FIGURE_SCHEDULERS = ("metronome", "default", "diktyo")
FIG11_LABELS = (("orig", False), ("halved_batch", True))
FIG11_CHANGE_MS = 30_000.0  # every S1 job's duty x 1.4 from here
FIG11_DUTY_MULT = 1.4
FIG12_SNAPSHOTS = ("S4", "S5")
FIG12_TAUS = (10.0, 40.0, 80.0)
FIG12_ITERATIONS = 300
FIG12_NODE = "worker-a30-2"  # the congested node whose latency is tau
THRESHOLD_SNAPSHOTS = ("S1", "S2", "S3")
THRESHOLD_O_T = (3, 5)
THRESHOLD_A_T = (1.05, 1.10, 1.15)
THRESHOLD_SIM = dict(BENCH_SIM, jitter_std=0.02)
FIG15_GAPS = (35.0, 30.0, 20.0, 10.0, 5.0, 0.0)
FIG15_POLICY = (1.10, 5)  # (a_t, o_t)
FIG15_MODEL, FIG15_PAIR = "FT-WideResNet101", "FT-VGG19-S3"
PERSISTENCE_SNAPSHOTS = ("S1", "S2", "S3")
PERSISTENCE_WINDOWS = (("short", 150_000.0, 400), ("long", 600_000.0, 5000))
PERSISTENCE_SIM = dict(seed=3, jitter_std=0.01)
ROTATION_POLICIES = (Policy("metronome", label="joint"),
                     Policy("metronome", rotation_joint=False,
                            label="legacy"))
ROTATION_ITERATIONS = 300
ROTATION_SIM = dict(BENCH_SIM, jitter_std=0.02)
PLANNER_REPS = 20
FABRIC_RATIOS = (1.0, 2.0, 4.0)
FABRIC_LAYOUT = dict(n_leaves=2, hosts_per_leaf=2, bw_gbps=25.0)
FABRIC_ITERATIONS = 300
FABRIC_SIM = dict(duration_ms=120_000.0, seed=3, jitter_std=0.01)
FABRIC_SCHEDULERS = ("metronome", "default", "diktyo", "ideal")
FABRIC_SNAPSHOT_SCHEDULERS = ("metronome", "default")
SCHED_NODES = 4
SCHED_NODE = dict(cpu=64, mem=512, gpu=8)
SCHED_BW_GBPS = 25.0
SCHED_PERIODS = (96.0, 90.0, 120.0, 245.0, 80.0)  # bg-0 .. bg-4
SCHED_JOB = dict(n_tasks=2, duty=0.45, bw_gbps=20.0)
SCHED_NEW_PERIOD = 96.0
SCHED_REPS = 5


def threshold_policy(a_t: float, o_t: int) -> Policy:
    return Policy("metronome").with_options(a_t=a_t, o_t=o_t)


@dataclasses.dataclass(frozen=True)
class BatchChangeBuild:
    """S1; with ``halved``, every job's duty x ``FIG11_DUTY_MULT`` from
    ``FIG11_CHANGE_MS`` on (Fig. 11's batch-size halving, typed events)."""

    halved: bool
    n_iterations: int = BENCH_ITERATIONS

    def __call__(self):
        cluster, wls, bg = make_snapshot("S1",
                                         n_iterations=self.n_iterations)
        changes = [events_mod.TrafficChange(FIG11_CHANGE_MS, j.name,
                                            FIG11_DUTY_MULT)
                   for wl in wls for j in wl.jobs] if self.halved else []
        return cluster, wls, bg, changes


@dataclasses.dataclass(frozen=True)
class TauBuild:
    """S4 or S5 with ``FIG12_NODE``'s latency to every other node set to
    ``tau`` ms (Fig. 12)."""

    sid: str
    tau: float
    n_iterations: int = FIG12_ITERATIONS

    def __call__(self):
        cluster, wls, bg = make_snapshot(self.sid,
                                         n_iterations=self.n_iterations)
        for other in cluster.node_names:
            if other != FIG12_NODE:
                cluster.set_latency(FIG12_NODE, other, self.tau)
        return cluster, wls, bg


@dataclasses.dataclass(frozen=True)
class FabricRatioBuild:
    """F2's workloads on a 2-leaf x 2-host fabric whose uplinks are
    oversubscribed ``ratio``:1 (``bench_fabric``)."""

    ratio: float
    n_iterations: int = FABRIC_ITERATIONS

    def __call__(self):
        cluster = make_fabric_cluster(**FABRIC_LAYOUT,
                                      oversubscription=self.ratio)
        _, wls, _ = make_snapshot("F2", n_iterations=self.n_iterations)
        return cluster, wls


def fig15_period(gap: float) -> float:
    """Fig. 15's WideResNet period: half its pair's, less ``gap`` ms."""
    return MODEL_FLEET[FIG15_PAIR]["period_ms"] / 2 - gap


@dataclasses.dataclass(frozen=True)
class GapBuild:
    """S3 with ``FIG15_MODEL``'s period at :func:`fig15_period` (Fig. 15).
    Only a snapshot's build reads the fleet, so the entry is set while S3
    is built and restored before the cell runs."""

    gap: float
    n_iterations: int = BENCH_ITERATIONS

    def __call__(self):
        with fleet_period(FIG15_MODEL, fig15_period(self.gap)):
            return make_snapshot("S3", n_iterations=self.n_iterations)


def paper_figure_grids() -> List[Grid]:
    """The grids of Figs. 11, 12, 14, 15, Table VI, J1 and the fabric
    sweep in the order they run; a scenario's name carries its variant
    (label, tau, gap, window, ratio), so every cell has a key of its own
    and one sweep holds a figure's cells."""
    schedulers = tuple(Policy(s) for s in FIGURE_SCHEDULERS)
    return [
        Grid("fig11", tuple(Scenario(f"S1-{label}", BatchChangeBuild(halved))
                            for label, halved in FIG11_LABELS),
             schedulers, BENCH_SIM),
        Grid("fig12", tuple(Scenario(f"{sid}-tau{int(tau)}",
                                     TauBuild(sid, tau))
                            for sid in FIG12_SNAPSHOTS
                            for tau in FIG12_TAUS),
             schedulers, BENCH_SIM),
        Grid("fig14", tuple(snapshot_scenario(
            sid, n_iterations=BENCH_ITERATIONS)
            for sid in THRESHOLD_SNAPSHOTS),
            tuple(threshold_policy(a_t, o_t) for o_t in THRESHOLD_O_T
                  for a_t in THRESHOLD_A_T), THRESHOLD_SIM),
        Grid("fig15", tuple(Scenario(f"S3-gap{gap:g}", GapBuild(gap))
                            for gap in FIG15_GAPS),
             (threshold_policy(*FIG15_POLICY),), THRESHOLD_SIM),
        Grid("tableVI", tuple(dataclasses.replace(snapshot_scenario(
            # Grid.run sets each cell's backend and device; "cpu" only
            # lets the config resolve where there is no card
            sid, n_iterations=iters, sim_config=SimConfig(
                duration_ms=dur, device="cpu", **PERSISTENCE_SIM)),
            name=f"{sid}-{label}")
            for sid in PERSISTENCE_SNAPSHOTS
            for label, dur, iters in PERSISTENCE_WINDOWS),
            (Policy("metronome"),), None),
        Grid("J1", (snapshot_scenario("J1",
                                      n_iterations=ROTATION_ITERATIONS),),
             ROTATION_POLICIES, ROTATION_SIM),
        Grid("fabric", tuple(Scenario(f"F2@{ratio:g}to1",
                                      FabricRatioBuild(ratio))
                             for ratio in FABRIC_RATIOS),
             tuple(Policy(s) for s in FABRIC_SCHEDULERS), FABRIC_SIM),
        Grid("fabric_snapshots", tuple(snapshot_scenario(
            sid, n_iterations=FABRIC_ITERATIONS)
            for sid in FABRIC_SNAPSHOTS),
            tuple(Policy(s) for s in FABRIC_SNAPSHOT_SCHEDULERS),
            FABRIC_SIM),
    ]


def _accel(sw: SweepResult, scn: str, other: str) -> Optional[float]:
    """Figs. 11 and 12's acceleration: 100 (1 - Metronome's mean time
    per 1000 iterations over ``other``'s), over the jobs both report."""
    me = sw.get(scn, "metronome").sim.time_per_1000_iters_s
    o = sw.get(scn, other).sim.time_per_1000_iters_s
    both = sorted(set(me) & set(o))
    return _pct(float(np.mean([me[j] for j in both])),
                float(np.mean([o[j] for j in both])))


def worst_planning_score(cluster, registry, ctrl) -> float:
    """The worst per-link Eq. 18 score of the controller's final global
    offsets under the planning demand view (100: every link feasible)."""
    view = LinkView.from_registry(cluster, registry)
    worst = 100.0
    for lid, st in ctrl.links.items():
        sch = st.scheme
        duties, _ = view.recalc_traffic(lid, sch.jobs, sch.muls, sch.base_ms)
        pats = geometry.pattern_matrix(sch.muls, duties, ctrl.di_pre)
        shifts = np.array([
            geometry.delay_to_shift_slots(ctrl.job_offset_ms(j), sch.base_ms,
                                          ctrl.di_pre)
            for j in sch.jobs])
        groups = view.link_groups(lid)
        bws = [sum(t.traffic.bw_gbps for t in groups.get(j, []))
               for j in sch.jobs]
        worst = min(worst, float(scoring.score_combos(
            pats, np.asarray(bws), cluster.link_alloc(lid),
            shifts[None, :])[0]))
    return worst


def _sched_cluster() -> Cluster:
    return Cluster([Node(f"n{i}", Resources(**SCHED_NODE),
                         bw_gbps=SCHED_BW_GBPS) for i in range(SCHED_NODES)])


SCHED_PLUGINS = {"metronome": lambda c: MetronomePlugin(controller=c),
                 "default": lambda c: DefaultPlugin(),
                 "diktyo": lambda c: DiktyoPlugin()}


def _sched_framework(plugin: str, n_jobs: int):
    """Fig. 16's cluster with ``n_jobs`` of its background jobs placed."""
    cluster, ctrl = _sched_cluster(), StopAndWaitController()
    fw = SchedulingFramework(cluster, SCHED_PLUGINS[plugin](ctrl))
    for i in range(n_jobs):
        j = make_job(f"bg-{i}", period_ms=SCHED_PERIODS[i], **SCHED_JOB)
        fw.schedule_workload(Workload(name=j.name, jobs=[j]))
    return cluster, ctrl, fw


def sched_placement(plugin: str, n_existing: int) -> dict:
    """Fig. 16's placement row: a new job placed and evicted
    ``SCHED_REPS`` times beside ``n_existing`` jobs, host µs a placement
    and ms a pod, and the nodes the first placement chose."""
    _, _, fw = _sched_framework(plugin, n_existing)
    new = make_job("new", period_ms=SCHED_NEW_PERIOD, **SCHED_JOB)
    nodes = None
    t0 = time.perf_counter()
    for r in range(SCHED_REPS):
        for t in new.tasks:
            t.node = None
        fw.schedule_workload(Workload(name=f"new-{r}", jobs=[new]))
        if nodes is None:
            nodes = [t.node for t in new.tasks]
        fw.evict_job(new)
    us = (time.perf_counter() - t0) / SCHED_REPS * 1e6
    return dict(plugin=plugin, existing_jobs=n_existing, host_us=us,
                ms_per_pod=us / SCHED_JOB["n_tasks"] / 1e3, nodes=nodes)


def sched_recalculation(n_jobs: int) -> dict:
    """Fig. 16's recalculation row: the controller's offline
    recalculation over every link with ``n_jobs`` jobs placed, host s,
    and the global offsets it gives."""
    cluster, ctrl, fw = _sched_framework("metronome", n_jobs)
    ctrl.pending_recalc = list(ctrl.links.keys())
    t0 = time.perf_counter()
    ctrl.run_offline_recalculation(fw.registry, cluster)
    host_s = time.perf_counter() - t0
    return dict(jobs=n_jobs, host_s=host_s,
                offsets_ms={f"bg-{i}": ctrl.job_offset_ms(f"bg-{i}")
                            for i in range(n_jobs)})


def figure_summary(got: Dict[str, SweepResult]) -> dict:
    """The benches' derived numbers from the card's cells under their
    ``emit`` names, printed, not gated: Figs. 11 and 12's acceleration,
    Fig. 14's low-priority increase over the best thresholds and
    readjustments, Fig. 15's times per 1000 iterations, Table VI's short
    and long windows, J1's low-priority JCT saving, the fabric sweep's
    JCT gain over Default and uplink utilisation."""
    fig11 = {}
    for label, _ in FIG11_LABELS:
        scn = f"S1-{label}"
        me = got["fig11"].get(scn, "metronome")
        for other in FIGURE_SCHEDULERS[1:]:
            fig11[f"fig11_{label}_accel_vs_{other}"] = dict(
                accel_pct=_accel(got["fig11"], scn, other),
                gamma_me=_finite(me.sim.avg_bw_utilization),
                gamma_other=_finite(got["fig11"].get(scn, other)
                                    .sim.avg_bw_utilization))
    fig12 = {f"fig12_{sid}_tau{int(tau)}_vs_{other}": dict(
        accel_pct=_accel(got["fig12"], f"{sid}-tau{int(tau)}", other))
        for sid in FIG12_SNAPSHOTS for tau in FIG12_TAUS
        for other in FIGURE_SCHEDULERS[1:]}
    fig14 = {}
    for sid in THRESHOLD_SNAPSHOTS:
        rows = []
        for o_t in THRESHOLD_O_T:
            for a_t in THRESHOLD_A_T:
                res = got["fig14"].get(sid, threshold_policy(a_t, o_t).name)
                rows.append((a_t, o_t, res.mean_s_per_1000(res.low_priority),
                             res.sim.readjustments))
        best = min(r[2] for r in rows)
        for a_t, o_t, lo_t, readj in rows:
            fig14[f"fig14_{sid}_AT{int(a_t * 100)}_OT{o_t}"] = dict(
                lo_increase_pct=_gap(lo_t, best), readj=readj)
    fig15 = {}
    for gap in FIG15_GAPS:
        res = got["fig15"].get(f"S3-gap{gap:g}",
                               threshold_policy(*FIG15_POLICY).name)
        fig15[f"fig15_gap{int(gap)}ms"] = dict(
            lo_s_per_1000=_finite(res.mean_s_per_1000(res.low_priority)),
            hi_s_per_1000=_finite(res.mean_s_per_1000(res.high_priority)))
    table6 = {}
    for sid in PERSISTENCE_SNAPSHOTS:
        short = got["tableVI"].get(f"{sid}-short", "metronome")
        long_ = got["tableVI"].get(f"{sid}-long", "metronome")
        hi, lo = short.high_priority, short.low_priority
        table6[f"tableVI_{sid}"] = dict(
            lo_short=_finite(short.mean_s_per_1000(lo)),
            lo_long=_finite(long_.mean_s_per_1000(lo)),
            hi_short=_finite(short.mean_s_per_1000(hi)),
            hi_long=_finite(long_.mean_s_per_1000(hi)))
    lo_jct = {p.name: got["J1"].get("J1", p.name).sim.finish_times_ms.get(
        "j1-local", float("nan")) for p in ROTATION_POLICIES}
    fabric = {}
    for ratio in FABRIC_RATIOS:
        scn = f"F2@{ratio:g}to1"
        for sched in FABRIC_SCHEDULERS:
            r = got["fabric"].get(scn, sched)
            iters = [v for v in r.sim.time_per_1000_iters_s.values()
                     if not math.isnan(v)]
            fabric[f"fabric_{ratio:g}to1_{sched}"] = dict(
                avg_jct_s=_finite(r.mean_jct_ms() / 1e3),
                s_per_1000=_finite(np.mean(iters)) if iters else None,
                uplink_util=max(r.sim.uplink_utilization.values(),
                                default=0.0))
        fabric[f"fabric_{ratio:g}to1_metronome_gain"] = dict(
            jct_gain_vs_default_pct=_pct(
                got["fabric"].get(scn, "metronome").mean_jct_ms(),
                got["fabric"].get(scn, "default").mean_jct_ms()))
    for sid in FABRIC_SNAPSHOTS:
        for sched in FABRIC_SNAPSHOT_SCHEDULERS:
            r = got["fabric_snapshots"].get(sid, sched)
            fabric[f"fabric_{sid}_{sched}"] = dict(
                avg_jct_s=_finite(r.mean_jct_ms() / 1e3),
                uplink_util=max(r.sim.uplink_utilization.values(),
                                default=0.0),
                readj=r.sim.readjustments)
    return dict(
        fig11=fig11, fig12=fig12, fig14=fig14, fig15=fig15, tableVI=table6,
        rotation_J1_joint_vs_legacy=dict(lo_jct_saving_pct=_pct(
            lo_jct["joint"], lo_jct["legacy"])),
        rotation_J1_tct_s={p.name: _finite(got["J1"].get(
            "J1", p.name).sim.total_completion_ms / 1e3)
            for p in ROTATION_POLICIES},
        fabric=fabric)


# ---------------------------------------------------------------------------
# the graceful-degradation bench: the settings of the reference's
# bench_robustness (DESIGN.md section 19), copied because it imports the
# JAX package; tests/test_torch_robustness_grid.py holds each to the
# bench's own value
# ---------------------------------------------------------------------------

SAMPLE_PERIOD_MS = 1000.0
AXIS_BASE_NOISE = 0.1  # the staleness and failure axes' fixed noise
ROBUST_POLICIES = (
    Policy("metronome"),
    Policy("metronome", label="metronome-robust").with_options(
        hysteresis_ms=3000.0, hysteresis_frac=0.05, reconcile=True))
ROBUST_SEEDS = (3, 4, 5)
ROBUST_JITTER = 0.01
ROBUST_SIM_MS = 150_000.0
ROBUST_DYNAMIC_KW = dict(n_iterations=300, t_on_ms=15_000.0,
                         t_off_ms=45_000.0)
ROBUST_FAULT_KW = dict(n_iterations=300, start_ms=20_000.0,
                       period_ms=15_000.0, down_ms=2_000.0)
NOISE_GRID = (0.0, 0.05, 0.1, 0.2, 0.4)
STALENESS_GRID = (0.0, 2_000.0, 5_000.0, 10_000.0)
FLAP_GRID = (0, 2, 4, 8)
TRACE_NOISE_GRID = (0.0, 0.2)
ROBUST_TRACE_KW = dict(duration_s=900.0, total_gpus=13, target_load=0.85,
                       seed=1, job_duration_range_s=(120.0, 240.0))
ROBUST_TRACE_JOBS = 8
ROBUST_TRACE_MS = 600_000.0
ROBUST_TRACE_NAME = "gavel-small"
# (axis, scenario, x values) in the bench's order, each from its x = 0
ROBUST_AXES = (("noise", "D1", NOISE_GRID), ("noise", "D2", NOISE_GRID),
               ("staleness", "D2", STALENESS_GRID),
               ("failure", "R1", FLAP_GRID),
               ("trace", ROBUST_TRACE_NAME, TRACE_NOISE_GRID))
ROBUST_COLUMNS = ("t1000", "hi", "lo", "readj", "reconf", "supp", "recon")
TWIN_NICE = 10  # the CPU twins' priority beside the card side


def robust_trace() -> List[TraceJobSpec]:
    return generate_trace(MODEL_FLEET, **ROBUST_TRACE_KW)[:ROBUST_TRACE_JOBS]


def robust_channel(axis: str, x: float) -> TelemetryChannel:
    """A run's telemetry channel: ``x`` is the noise on the noise and
    trace axes and the staleness (ms) on the staleness axis; the
    staleness and failure axes hold the noise at ``AXIS_BASE_NOISE``."""
    return TelemetryChannel(
        sample_period_ms=SAMPLE_PERIOD_MS,
        noise_std=x if axis in ("noise", "trace") else AXIS_BASE_NOISE,
        staleness_ms=x if axis == "staleness" else 0.0)


def robust_name(axis: str, sid: str, x: float, seed: int) -> str:
    return f"{axis}-{sid}-x{x:g}-s{seed}"


def robust_scenario(axis: str, sid: str, x: float, seed: int,
                    trace: Sequence[TraceJobSpec]) -> Scenario:
    """One run of the bench, its ``SimConfig`` (seed and channel) carried
    by its scenario and its name carrying (axis, scenario, x, seed)."""
    # Grid.run sets each run's backend and device; "cpu" only lets the
    # config resolve where there is no card
    cfg = SimConfig(
        duration_ms=ROBUST_TRACE_MS if axis == "trace" else ROBUST_SIM_MS,
        seed=seed, jitter_std=ROBUST_JITTER,
        telemetry=robust_channel(axis, x), device="cpu")
    if axis == "trace":
        scn = trace_scenario(trace, open_ended=True, name=sid,
                             sim_config=cfg)
    elif axis == "failure":
        scn = fault_scenario(sid, n_cycles=int(x), sim_config=cfg,
                             **ROBUST_FAULT_KW)
    else:
        scn = dynamic_scenario(sid, sim_config=cfg, **ROBUST_DYNAMIC_KW)
    return dataclasses.replace(scn, name=robust_name(axis, sid, x, seed))


def robustness_grids(trace: Sequence[TraceJobSpec]) -> List[Grid]:
    """One grid an (axis, scenario): every (x, seed) run under both
    policies, 120 runs in all."""
    return [Grid(f"{axis}_{sid}", tuple(
        robust_scenario(axis, sid, x, seed, trace)
        for x in xs for seed in ROBUST_SEEDS), ROBUST_POLICIES, None)
        for axis, sid, xs in ROBUST_AXES]


def robust_point(results: Sequence) -> Dict[str, float]:
    """``bench_robustness._point``: each column's mean over the seeds'
    results, NaNs left out, NaN where every seed's is."""
    cols: Dict[str, List[float]] = {k: [] for k in ROBUST_COLUMNS}
    for r in results:
        cols["t1000"].append(r.mean_s_per_1000())
        cols["hi"].append(r.mean_s_per_1000(r.high_priority))
        cols["lo"].append(r.mean_s_per_1000(r.low_priority))
        cols["readj"].append(float(r.sim.readjustments))
        cols["reconf"].append(float(r.sim.reconfigurations))
        cols["supp"].append(float(r.sim.suppressed_reconfigurations))
        cols["recon"].append(float(r.sim.reconciliations))
    return {k: float(np.nanmean(v)) if any(not math.isnan(x) for x in v)
            else math.nan for k, v in cols.items()}


def robustness_rows(result) -> List[dict]:
    """``bench_robustness._sweep_axis``'s rows, axis by axis, policy by
    policy, x by x: the seed means and the degradation against the same
    (axis, scenario, policy)'s x = 0 point.  ``result(axis, scenario, x,
    policy, seed)`` gives a run's result."""
    rows = []
    for axis, sid, xs in ROBUST_AXES:
        for pol in ROBUST_POLICIES:
            anchor = None
            for x in xs:
                m = robust_point([result(axis, sid, x, pol.name, seed)
                                  for seed in ROBUST_SEEDS])
                if anchor is None:
                    anchor = m["t1000"]
                rows.append(dict(
                    axis=axis, scenario=sid, policy=pol.name, x=float(x),
                    seeds=len(ROBUST_SEEDS), t1000_mean_s=m["t1000"],
                    t1000_hi_s=m["hi"], t1000_lo_s=m["lo"],
                    degradation=m["t1000"] / anchor if anchor else math.nan,
                    readjustments=m["readj"], reconfigurations=m["reconf"],
                    suppressed_reconfigurations=m["supp"],
                    reconciliations=m["recon"]))
    return rows


def robustness_summary(rows: Sequence[dict]) -> dict:
    """Each axis's curve under both policies and the failure axis's
    slope at its most cycles, (degradation - 1) a cycle: the bench's
    claim is that the robust policy's is the shallower (printed, not
    gated)."""
    curves: Dict[str, Dict[str, list]] = {}
    for r in rows:
        curves.setdefault(f"{r['axis']}_{r['scenario']}", {}).setdefault(
            r["policy"], []).append(dict(
                x=r["x"], t1000_s=r["t1000_mean_s"],
                degradation=r["degradation"],
                reconfigurations=r["reconfigurations"],
                suppressed=r["suppressed_reconfigurations"],
                reconciliations=r["reconciliations"]))
    slope = {r["policy"]: (r["degradation"] - 1.0) / r["x"] for r in rows
             if r["axis"] == "failure" and r["x"] == FLAP_GRID[-1]
             and r["degradation"] is not None}
    plain, robust = (p.name for p in ROBUST_POLICIES)
    return dict(curves=curves,
                failure_slope_per_cycle=dict(cycles=FLAP_GRID[-1], **slope),
                robust_slope_shallower=slope[robust] < slope[plain]
                if len(slope) == 2 else None)


def _twin_worker_init() -> None:
    """A CPU twin's worker: the card hidden before anything asks for
    it, one torch thread, a lower priority than the card side's."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    torch.set_num_threads(1)
    os.nice(TWIN_NICE)


def _twin_cell(grid: Grid) -> Tuple[SweepCell, float, bool]:
    """A one-cell grid's CPU twin in a worker: its cell, its seconds, and
    whether the worker's CUDA was initialised (it must not be)."""
    t0 = time.perf_counter()
    (cell,) = grid.run("cpu").cells
    return cell, time.perf_counter() - t0, torch.cuda.is_initialized()


class TwinPool:
    """The CPU twins of ``grids``, one task a cell, submitted at once to
    ``workers`` spawned processes (:func:`_twin_worker_init`) that run
    beside the card side; :meth:`sweep` waits for one grid's."""

    def __init__(self, grids: Sequence[Grid], workers: int) -> None:
        from concurrent.futures import ProcessPoolExecutor
        self.workers = workers
        self.t0 = time.perf_counter()
        self.done: List[float] = []
        self.pool = ProcessPoolExecutor(
            max_workers=workers, initializer=_twin_worker_init,
            mp_context=multiprocessing.get_context("spawn"))
        self.futures = {g.name: [self.pool.submit(
            _twin_cell, dataclasses.replace(g, scenarios=(s,),
                                            policies=(p,)))
            for s in g.scenarios for p in g.policies]
            for g in grids if g.twin}
        for fs in self.futures.values():
            for f in fs:
                f.add_done_callback(
                    lambda _: self.done.append(time.perf_counter()))

    def __enter__(self) -> "TwinPool":
        return self

    def __exit__(self, *exc) -> None:
        self.pool.shutdown(wait=True, cancel_futures=True)

    def sweep(self, grid: Grid) -> Tuple[SweepResult,
                                         Dict[Tuple[str, str], float]]:
        """``grid``'s twin as ``sweep`` gives it (row-major cells), and
        each cell's seconds in its worker."""
        outs = [f.result() for f in self.futures[grid.name]]
        check(not any(cuda for _, _, cuda in outs),
              f"a CPU twin of {grid.name} initialised CUDA")
        return (SweepResult(cells=[c for c, _, _ in outs]),
                {(c.scenario, c.policy): s for c, s, _ in outs})

    def stats(self) -> dict:
        return dict(workers=self.workers, cells=len(self.done),
                    wall_s=max(self.done, default=self.t0) - self.t0)


def twin_workers() -> int:
    """The CPU twins' processes: the host's cores less one for the card
    side's process and one for the rest."""
    return max(1, len(os.sched_getaffinity(0)) - 2)


def schedule_snapshot(sid: str, n_iterations: int = 100,
                      joint: bool = True):
    """``sid`` scheduled by the Metronome plugin with the joint planner
    (or the per-link one): the cluster, framework and controller."""
    cluster, wls, _ = make_snapshot(sid, n_iterations=n_iterations)
    ctrl = StopAndWaitController(joint=joint)
    fw = SchedulingFramework(cluster, MetronomePlugin(controller=ctrl,
                                                      joint=joint))
    for wl in wls:
        fw.schedule_workload(wl)
    return cluster, fw, ctrl


def planner_links(sid: str, view: LinkView, registry) -> List[str]:
    """J1: every link with a per-link scheme (tests/test_rotation.py);
    F4: the contended uplinks (benchmarks/bench_rotation.py)."""
    if sid == "F4":
        return [l for l in view.planning_links() if is_uplink(l)]
    return [l for l in view.planning_links()
            if rotation.solve_link(view, registry, l)[1] is not None]


def candidate_specs(cluster, registry, links: Sequence[str], n: int):
    """``n`` candidate views of one component that differ only in their
    host links' allocatable bandwidth (the candidate delta of a Score
    phase), so ``joint_solve_batch`` scores them as one problem family."""
    specs = []
    for k in range(n):
        cl = cluster.copy()
        for lid in links:
            if lid in cl.nodes:
                node = cl.nodes[lid]
                node.allocatable_gbps = node.bw_gbps * (1.0 + 0.002 * k)
        specs.append((LinkView.from_registry(cl, registry), list(links)))
    return specs


# ---------------------------------------------------------------------------
# kernel inputs as the paths give them
# ---------------------------------------------------------------------------

class Recorder:
    """Keeps the inputs the ops entry points received while active (at
    most ``keep`` calls per input shape; host arrays copied, tensors cloned
    on their device) and the host time spent in them.  For the Metronome
    ops that is the cast, the copy to the device, the launch and the copy
    back, which ends in a synchronisation; the model ops only enqueue."""

    NAMES = ("progressive_fill", "score_multilink", "score_multilink_batch",
             "flash_attention", "flash_attention_bwd", "rg_lru",
             "rg_lru_bwd")

    def __init__(self, keep: int = 1) -> None:
        self.keep = keep
        self.calls: Dict[str, Dict[tuple, list]] = {n: {} for n in self.NAMES}
        self.counts: Dict[str, Dict[tuple, int]] = {n: {} for n in self.NAMES}
        self.seconds: Dict[str, float] = {n: 0.0 for n in self.NAMES}

    @contextlib.contextmanager
    def active(self):
        saved = {n: getattr(ops, n) for n in self.NAMES}

        def wrap(name, fn):
            def recorded(*args, **kw):
                shape = tuple(np.shape(a) for a in args)
                self.counts[name][shape] = self.counts[name].get(shape, 0) + 1
                kept = self.calls[name].setdefault(shape, [])
                if len(kept) < self.keep:
                    kept.append([a.detach().clone()
                                 if isinstance(a, torch.Tensor)
                                 else np.array(a, copy=True) for a in args])
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                self.seconds[name] += time.perf_counter() - t0
                return out
            return recorded

        for n in self.NAMES:
            setattr(ops, n, wrap(n, saved[n]))
        try:
            yield self
        finally:
            for n, fn in saved.items():
                setattr(ops, n, fn)

    def n_calls(self, name: str) -> int:
        return sum(self.counts[name].values())

    def inputs(self, name: str) -> List[list]:
        return [a for kept in self.calls[name].values() for a in kept]

    def most_common(self, name: str) -> Tuple[tuple, int, list]:
        shape, n = max(self.counts[name].items(), key=lambda kv: kv[1])
        return shape, n, self.calls[name][shape][0]


def score_counts(launches: Dict[str, int]) -> Dict[str, int]:
    """The score wrappers' launches recorded in ``launches`` so far: a
    phase takes them before and after its runs and reads the difference,
    since ``launches`` sums every phase's."""
    return {w.__name__: launches.get(w.__name__, 0) for w in SCORE_WRAPPERS}


@contextlib.contextmanager
def counted(launches: Dict[str, int]):
    """Zero every wrapper's launch count, run the path, record the counts."""
    for w in ALL_WRAPPERS:
        w.launches = 0
    yield
    for w in ALL_WRAPPERS:
        name = w.__name__
        launches[name] = launches.get(name, 0) + w.launches


def _profiled(fn, record_shapes: bool = False):
    """Run ``fn`` under ``torch.profiler``: (profile, wall µs, device busy
    µs (kernels and copies, one stream, so no overlap), device µs by
    kernel name).  The trace holds the device's activity alone unless
    ``record_shapes`` asks for the host's ops and their input shapes: with
    them, reading back a path of ~10^5 small launches takes minutes."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                            if record_shapes else [])
    with profile(activities=activities,
                 record_shapes=record_shapes) as prof:
        t0 = time.perf_counter()
        fn()
        _sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = 0.0
    by_kernel: Dict[str, float] = {}
    for ev in _device_events(prof.events()):
        busy_us += ev.self_device_time_total
        by_kernel[ev.name] = (by_kernel.get(ev.name, 0.0)
                              + ev.self_device_time_total)
    return prof, wall_us, busy_us, by_kernel


def _device_events(events):
    """The device's own work among a profile's events or rows: kernels,
    copies and fills.  A span (``record_function``, as the port's train
    step and AdamW open while a profiler records) also comes back as a
    CUDA event, a ``gpu_user_annotation`` whose time is that of the
    kernels inside it: counting it would count those kernels again."""
    return [ev for ev in events
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and not ev.is_user_annotation]


def _busy_summary(wall_us: float, busy_us: float,
                  by_kernel: Dict[str, float], note: str) -> dict:
    if busy_us <= 0.0:
        return {"busy_share": "not measured", "wall_s": wall_us / 1e6}
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    return {"busy_share": busy_us / wall_us, "busy_s": busy_us / 1e6,
            "wall_s": wall_us / 1e6,
            "top_device_us": {k[:60]: v for k, v in top}, "note": note}


def device_busy_share(fn, note: str) -> dict:
    """The device's busy time over the wall time while ``fn`` runs, and
    its six largest kernels; "not measured" where the trace holds no
    device event."""
    _, wall_us, busy_us, by_kernel = _profiled(fn)
    return _busy_summary(wall_us, busy_us, by_kernel, note)


def train_step_profile(fn, seq: int, vocab: int) -> dict:
    """:func:`device_busy_share` of one training step, plus device time by
    source: the LM head's float32 products (``aten::mm`` with a
    vocab-sized dimension, where the head's operands do not take its
    kernels) and its kernels (``lm_head``), any plain attention over (seq,
    seq) scores (``aten::bmm``: the recompute through ``attention_ref``
    that the backward kernel replaced; the train phases check it reads 0),
    the other products, and the port's kernels.
    ``seq_bmm_ms_by_the_old_rule`` reads, outside the split, every
    ``aten::bmm`` with two seq-sized dimensions, the rule the split used
    before the backward kernel: the plain attention and the weight
    gradients that contract over seq."""
    prof, wall_us, busy_us, by_kernel = _profiled(fn, record_shapes=True)
    out = _busy_summary(wall_us, busy_us, by_kernel,
                        "one step on the repeated batch under torch.profiler")
    if busy_us <= 0.0:
        return out
    ops = {"lm_head_mm": 0.0, "attention_ref_bmm": 0.0, "other_mm_bmm": 0.0}
    old_rule = 0.0  # the former rule: any bmm with two seq-sized dims
    for row in prof.key_averages(group_by_input_shape=True):
        if row.key not in ("aten::mm", "aten::bmm"):
            continue
        # self time: under remat "dots" the selective-checkpoint mode runs
        # each forward product inside the dispatcher's own aten::mm event,
        # so a product's kernel sits under two aten::mm events
        us = row.self_device_time_total
        dims = [d for shape in row.input_shapes for d in shape]
        if vocab in dims:
            ops["lm_head_mm"] += us
            continue
        if row.key == "aten::bmm" and dims.count(seq) >= 2:
            old_rule += us
        if row.key == "aten::bmm" and _seq_by_seq(row.input_shapes, seq):
            ops["attention_ref_bmm"] += us
        else:
            ops["other_mm_bmm"] += us
    for name, keys in (("flash_fwd", FLASH_KERNELS),
                       ("flash_bwd", FLASH_BWD_KERNELS),
                       ("rg_lru", ("rg_lru_kernel",)),
                       ("rg_lru_bwd", ("rg_lru_bwd_kernel",)),
                       ("lm_head", LM_HEAD_KERNELS)):
        ops[name] = sum(us for k, us in by_kernel.items()
                        if any(key in k for key in keys))
    ops["rest"] = busy_us - sum(ops.values())
    out["device_ms_by_source"] = {k: v / 1e3 for k, v in ops.items()}
    out["seq_bmm_ms_by_the_old_rule"] = old_rule / 1e3  # in the split
    return out


def _seq_by_seq(shapes, seq: int) -> bool:
    """A batched product over (seq, seq) attention scores: an operand that
    is (.., seq, seq), or (.., seq, d) times (.., d, seq).  A product that
    only contracts over seq (a weight's gradient, (d, seq) x (seq, n)) is
    not one."""
    mats = [list(t) for t in shapes if len(t) >= 2][:2]
    if len(mats) < 2:
        return False
    a, b = mats
    return any(t[-2:] == [seq, seq] for t in mats) or \
        (a[-2] == seq and b[-1] == seq)


def _sync() -> None:
    torch.cuda.synchronize()


def time_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after warm-up."""
    for _ in range(warmup):
        fn()
    _sync()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def device_us(fn, kernels: Optional[Sequence[str]],
              reps: int = 200, per_launch: int = 1,
              per_call: bool = False) -> dict:
    """Device-only time per launch of the kernels whose names hold one of
    ``kernels``, over ``reps`` calls of ``fn``: their CUDA time under
    ``torch.profiler`` over their launches that the trace holds.  A
    wrapper whose launch runs ``per_launch`` distinct kernels (the
    attention backward's three) gets the sum of each kernel's own mean,
    so a kernel that lost more records than another weighs no more.
    With ``kernels`` None (a library call, whose kernels this script does
    not name) it is every device event's time a call, and
    ``device_kernels`` names the events: over the launches of the event
    that took the most (one launch a call, as a library's forward), or,
    with ``per_call``, over the calls the trace holds (a path of many
    kernels: a recompute, a library's backward): the fewest launches of
    any event that ran in at least every other call, since each such
    path runs some kernel once a call.  A trace loses the
    first records of a burst of launches, more of them the longer the
    process has run (PERF.md), so the burst is long and
    ``device_traced`` reports the share of the launches it holds; a
    trace that holds none of them (a burst of a few-microsecond kernel
    late in the run can lose all its records) is taken again with a
    burst four times as long, twice at most, and ``device_attempts``
    counts the traces taken.  Fails, naming the device events the last
    trace does hold, where none holds these kernels'."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    _sync()
    for attempt in range(1, 4):
        ran = sum(w.launches for w in ALL_WRAPPERS)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            _sync()
        ran = sum(w.launches for w in ALL_WRAPPERS) - ran
        if kernels is None or ran == 0:  # a library's or a raw launch
            ran = reps
        seen: Dict[str, int] = {}
        by_key: Dict[str, Tuple[float, int]] = {}
        for ev in _device_events(prof.key_averages()):
            seen[ev.key[:60]] = ev.count
            if kernels is None or any(k in ev.key for k in kernels):
                by_key[ev.key] = (ev.self_device_time_total, ev.count)
        total_us = sum(us for us, _ in by_key.values())
        counts = [n for _, n in by_key.values()]
        if kernels is None and per_call:
            count = min((n for _, n in by_key.values() if 2 * n >= reps),
                        default=0)
        elif kernels is None:
            count = max(by_key.values(), default=(0.0, 0))[1]
        elif per_launch > 1:
            count = min(counts, default=0) \
                if len(by_key) == per_launch else 0
        else:
            count = sum(counts)
        if total_us > 0.0 and count > 0:
            break
        reps *= 4
    check(total_us > 0.0 and count > 0,
          f"torch.profiler holds none of {ran} launches of {kernels} "
          f"({per_launch} distinct kernels a launch): the trace's device "
          f"events {seen}")
    if kernels is not None and per_launch > 1:
        per = sum(us / n for us, n in by_key.values())
    else:
        per = total_us / count
    out = dict(device_us_per_launch=per, device_traced=count / ran,
               device_attempts=attempt)
    if kernels is None:
        out["device_kernels"] = seen
    elif per_launch > 1:  # each kernel's own mean
        out["device_us_by_kernel"] = {
            _kernel_name(k): us / n for k, (us, n) in by_key.items()}
    return out


def _kernel_name(key: str) -> str:
    """A profiler's kernel name without its return type, namespace and
    parameter list: ``flash_bwd_bf16_dq<128>``."""
    return key.replace("(anonymous namespace)::", "").split("(")[0] \
        .replace("void ", "").strip()


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    info = {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": line,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0]}
    emit("device", **info)
    return info


def phase_build() -> Dict[str, Dict[str, dict]]:
    """Build every source; return each one's ptxas summary by entry."""
    t0 = time.perf_counter()
    reports = _cuda_build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {name: _cuda_build.ptxas_summary(log)
             for name, log in reports.items()}
    notes = {name: [ln.strip() for ln in log.splitlines()
                    if "warning" in ln or "Performance Loss" in ln]
             for name, log in reports.items()}
    emit("build", seconds=seconds, sources=list(_cuda_build.SOURCES),
         built=sorted(reports), ptxas=ptxas,
         ptxas_notes={k: v for k, v in notes.items() if v})
    return ptxas


def phase_trace_corpus(launches, rec: Recorder, n_jobs: int = 10_000,
                       n_snap: int = 1024) -> dict:
    t0 = time.perf_counter()
    trace = generate_production_trace(MODEL_FLEET, n_jobs=n_jobs, seed=7)
    horizon = max(s.submit_time_s for s in trace)
    probs = [snapshot_problem(trace, horizon * (i + 0.5) / n_snap)
             for i in range(n_snap)]
    probs = [p for p in probs if p[0]]
    mats = [fluid.problem_matrix(d, p, c)[:3] for d, p, c in probs]
    n_flows = sum(len(p[0]) for p in probs)
    setup_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    golden = [fluid.fill_python(np.asarray(d, dtype=float), p, c)
              for d, p, c in probs]
    oracle_s = time.perf_counter() - t0

    fluid.fill_corpus(mats, backend="kernel", device=DEVICE)  # warm-up
    before = launches.get("metronome_fill", 0)
    with counted(launches), rec.active():
        t0 = time.perf_counter()
        rates = fluid.fill_corpus(mats, backend="kernel", device=DEVICE)
        seconds = time.perf_counter() - t0
    fill_launches = launches["metronome_fill"] - before
    err = max(float(np.max(np.abs(r - g))) if len(g) else 0.0
              for r, g in zip(rates, golden))
    check(fill_launches > 0, "trace corpus launched no fill")
    check(err <= ORACLE_TOL,
          f"trace corpus: kernel vs fill_python max abs err {err} > "
          f"{ORACLE_TOL}")
    out = dict(n_jobs=len(trace), n_problems=len(probs), n_flows=n_flows,
               max_flows=max(len(p[0]) for p in probs), n_links=9,
               seconds=seconds, problems_per_s=len(probs) / seconds,
               flows_per_s=n_flows / seconds, oracle_seconds=oracle_s,
               setup_seconds=setup_s, fill_launches=fill_launches,
               max_abs_err_vs_fill_python=err)
    emit("trace_corpus", **out)
    return out


def phase_experiment(launches, rec: Recorder, n_jobs: int) -> dict:
    trace = generate_production_trace(MODEL_FLEET, n_jobs=n_jobs, seed=7,
                                      **TRACE_KW)
    scen = dynamic_trace_scenario(trace)
    cfg = dynamic_sim_config(trace, fluid_backend="kernel", device=DEVICE,
                             profile=True)
    before = launches.get("metronome_fill", 0)
    with audited_engines() as engines, counted(launches), rec.active():
        t0 = time.perf_counter()
        res = run(scen, DYNAMIC_POLICY, cfg)
        _sync()
        seconds = time.perf_counter() - t0
    fill_launches = launches["metronome_fill"] - before
    check(len(engines) == 1, f"expected one fluid engine, got {len(engines)}")
    eng = engines[0]
    err = audit_error(eng)
    sim = res.sim
    prof = sim.profile
    check(fill_launches > 0, "experiment launched no fill")
    check(len(eng.samples) > 0, "experiment sampled no in-loop solve")
    check(err <= ORACLE_TOL,
          f"experiment: in-loop fill vs fill_python max abs err {err}")
    check(math.isfinite(sim.total_completion_ms)
          and sim.total_completion_ms > 0, "total completion not finite")
    check(len(res.accepted) > 0, "no job was admitted")
    share = device_busy_share(
        lambda: run(dynamic_trace_scenario(trace[:n_jobs // 5]),
                    DYNAMIC_POLICY,
                    dynamic_sim_config(trace[:n_jobs // 5],
                                       fluid_backend="kernel",
                                       device=DEVICE)),
        "profiled run of the trace's first fifth")
    out = dict(n_jobs=n_jobs,
               cut=f"{n_jobs} of the reference bench's 10,000 jobs, for "
                   "the run's time limit",
               ticks=prof.ticks, solves=prof.solves, seconds=seconds,
               us_per_tick=seconds * 1e6 / max(1, prof.ticks),
               phase_seconds=prof.phase_seconds(),
               total_completion_ms=sim.total_completion_ms,
               accepted=len(res.accepted), pending=len(res.rejected),
               fill_launches=fill_launches,
               fill_op_calls=rec.n_calls("progressive_fill"),
               fill_op_seconds=rec.seconds["progressive_fill"],
               fill_op_us_per_call=rec.seconds["progressive_fill"] * 1e6
               / max(1, rec.n_calls("progressive_fill")),
               audited_solves=len(eng.samples),
               max_abs_err_vs_fill_python=err,
               device_busy=share,
               memo=dataclasses.asdict(eng.stats),
               corpus=eng.corpus_stats.as_dict())
    emit("experiment", **out)
    return out


def run_grids(phase: str, grids: Sequence[Grid], launches,
              rec: Recorder, twins: Optional[TwinPool] = None
              ) -> Tuple[Dict[str, SweepResult], dict]:
    """Each grid one ``sweep`` on the card and, where it has a twin, again
    on the CPU, whose results JSON must equal the card's: run here after
    the card's, or taken from ``twins``, whose workers ran it beside.
    Every card cell's in-loop solves are held against ``fill_python``; a
    cell without a twin must also sample some, admit a job and end at a
    finite time.  One ``phase`` line a cell.  Returns the card's sweeps by
    grid and the totals: cells, twinned cells, audited solves, their
    largest error, the fill's launches and op calls, and each grid's
    seconds (with ``twins``: the twin cells' seconds in their workers,
    and how long this process waited for them)."""
    got: Dict[str, SweepResult] = {}
    seconds: Dict[str, dict] = {}
    totals = dict(cells=0, cells_json_equal_to_cpu_twin=0, audited_solves=0,
                  max_abs_err_vs_fill_python=0.0)
    twin_rec = Recorder(keep=0)
    before = launches.get("metronome_fill", 0)
    calls = rec.n_calls("progressive_fill")
    with audited_engines(stride=1) as engines, counted(launches), \
            metered_runs({DEVICE: rec, "cpu": twin_rec}, engines) as meters:
        for grid in grids:
            t0 = time.perf_counter()
            with rec.active():
                card = grid.run(DEVICE)
                _sync()
            seconds[grid.name] = dict(card=time.perf_counter() - t0)
            check(not card.errors, f"{phase} {grid.name}: cells failed: "
                  + "\n".join(c.error for c in card.errors))
            twin = None
            if grid.twin and twins is not None:
                t0 = time.perf_counter()
                twin, twin_s = twins.sweep(grid)
                seconds[grid.name].update(
                    cpu=sum(twin_s.values()),
                    cpu_wait=time.perf_counter() - t0)
            elif grid.twin:
                t0 = time.perf_counter()
                with twin_rec.active():
                    twin = grid.run("cpu")
                seconds[grid.name]["cpu"] = time.perf_counter() - t0
                twin_s = {(c.scenario, c.policy): meters[
                    (c.scenario, c.policy, "cpu")]["seconds"]
                    for c in twin.cells}
            if twin is not None:
                check(not twin.errors, f"{phase} {grid.name}: CPU twin "
                      "cells failed: "
                      + "\n".join(c.error for c in twin.errors))
            got[grid.name] = card
            for cell in card.cells:
                res = cell.result
                meter = meters[(cell.scenario, cell.policy, DEVICE)]
                solves = sum(len(e.samples) for e in meter["engines"])
                err = max((audit_error(e) for e in meter["engines"]),
                          default=0.0)
                where = f"{phase} {grid.name} ({cell.scenario}, " \
                        f"{cell.policy})"
                check(err <= ORACLE_TOL, f"{where}: in-loop fill vs "
                      f"fill_python max abs err {err}")
                check(meter["fill_op_calls"] == 0
                      or meter["fill_launches"] > 0,
                      f"{where}: {meter['fill_op_calls']} fill op calls "
                      "launched no fill kernel")
                out = dict(grid=grid.name, scenario=cell.scenario,
                           policy=cell.policy, card_s=meter["seconds"])
                if twin is not None:
                    want = twin.get(cell.scenario, cell.policy)
                    check(res.to_json_dict() == want.to_json_dict(),
                          f"{where}: results JSON differs between the card "
                          "and its CPU twin")
                    out.update(cpu_s=twin_s[(cell.scenario, cell.policy)],
                               json_equal_to_cpu_twin=True)
                    totals["cells_json_equal_to_cpu_twin"] += 1
                else:
                    check(solves > 0, f"{where}: no in-loop solve sampled")
                    check(math.isfinite(res.sim.total_completion_ms)
                          and res.sim.total_completion_ms > 0,
                          f"{where}: total completion not finite")
                    check(len(res.accepted) > 0, f"{where}: no job admitted")
                out.update(
                    fill_launches=meter["fill_launches"],
                    fill_op_calls=meter["fill_op_calls"],
                    fill_op_us_per_call=meter["fill_op_seconds"] * 1e6
                    / max(1, meter["fill_op_calls"]),
                    fill_op_share=meter["fill_op_seconds"]
                    / meter["seconds"],
                    audited_solves=solves, max_abs_err_vs_fill_python=err,
                    **cell_numbers(res))
                if grid.cut:
                    out["cut"] = grid.cut
                emit(phase, **out)
                totals["cells"] += 1
                totals["audited_solves"] += solves
                totals["max_abs_err_vs_fill_python"] = max(
                    totals["max_abs_err_vs_fill_python"], err)
    totals.update(fill_launches=launches["metronome_fill"] - before,
                  fill_op_calls=rec.n_calls("progressive_fill") - calls,
                  grid_seconds=seconds)
    check(totals["fill_launches"] > 0, f"{phase} launched no fill")
    return got, totals


def phase_paper_grid(launches, rec: Recorder, n_jobs: int) -> dict:
    """The paper's evaluation grid (:func:`paper_grids`) through
    :func:`run_grids`; each cell but the production trace's twinned on
    the CPU.  One line a cell, then the summary."""
    t_phase = time.perf_counter()
    production = generate_production_trace(MODEL_FLEET, n_jobs=n_jobs,
                                           seed=7, **TRACE_KW)
    got, totals = run_grids("paper_grid", paper_grids(production), launches,
                            rec)
    # the cell with the most fill launches: a snapshot cell's two to five
    # can all fall among the records a late trace loses
    share = device_busy_share(
        lambda: run(dynamic_trace_scenario(production), Policy("diktyo"),
                    SimConfig(fluid_backend="kernel", device=DEVICE,
                              **dynamic_sim_kw(production))),
        "profiled run of the production cell (dynamic-trace, diktyo)")
    out = dict(seconds=time.perf_counter() - t_phase, **totals,
               device_busy_production_cell=share, **grid_summary(got))
    emit("paper_grid_summary", **out)
    return out


def planner_walltime(launches, rec: Recorder) -> dict:
    """``bench_rotation``'s F4 planner wall time: the per-link
    ``solve_link`` loop against ``joint_solve(backend="kernel")`` on the
    card, ``PLANNER_REPS`` calls each after a warm-up (host µs a call);
    the kernel's shifts and score held to the numpy backend's."""
    cluster, fw, ctrl = schedule_snapshot("F4", ROTATION_ITERATIONS)
    ctrl.run_offline_recalculation(fw.registry, cluster)
    view = LinkView.from_registry(cluster, fw.registry)
    links = [l for l in view.planning_links() if is_uplink(l)]

    def loop_path():
        return [rotation.solve_link(view, fw.registry, lid, mode="fast")
                for lid in links]

    def batched_path():
        return rotation.joint_solve(view, fw.registry, links, mode="fast",
                                    backend="kernel", device=DEVICE)

    want = rotation.joint_solve(view, fw.registry, links, mode="fast",
                                backend="numpy")
    before = score_counts(launches)
    with counted(launches):
        loop_path()
        with rec.active():
            got = batched_path()
        t0 = time.perf_counter()
        for _ in range(PLANNER_REPS):
            loop_path()
        t_loop = (time.perf_counter() - t0) / PLANNER_REPS * 1e6
        t0 = time.perf_counter()
        for _ in range(PLANNER_REPS):
            res = batched_path()
        t_batched = (time.perf_counter() - t0) / PLANNER_REPS * 1e6
    ran = {k: n - before[k] for k, n in score_counts(launches).items()}
    check(sum(ran.values()) > 0, "the F4 planner's kernel path launched no "
          "score kernel")
    for r in (got, res):
        check(np.array_equal(r.shifts, want.shifts),
              f"F4 planner: kernel shifts {r.shifts} != numpy "
              f"{want.shifts}")
        check(abs(r.score - want.score) <= SCORE_TOL,
              f"F4 planner: score {r.score} vs {want.score}")
    return dict(links=links, reps=PLANNER_REPS, loop_host_us=t_loop,
                batched_host_us=t_batched, score=res.score,
                shifts=[int(x) for x in res.shifts],
                speedup_vs_loop=t_loop / t_batched, score_launches=ran)


def phase_paper_figures(launches, rec: Recorder) -> dict:
    """The rest of the paper's evaluation (:func:`paper_figure_grids`)
    through :func:`run_grids`, every cell twinned on the CPU; J1's worst
    planning score under each policy; the F4 planner's wall time with the
    score kernel; Fig. 16's placement and recalculation rows (host time of
    the card's machine, no kernel).  One line a cell, one for Fig. 16,
    then the summary."""
    t_phase = time.perf_counter()
    got, totals = run_grids("paper_figures", paper_figure_grids(), launches,
                            rec)
    worst = {}
    for pol in ROTATION_POLICIES:
        cluster, fw, ctrl = schedule_snapshot("J1", ROTATION_ITERATIONS,
                                              pol.rotation_joint)
        ctrl.run_offline_recalculation(fw.registry, cluster)
        worst[pol.name] = worst_planning_score(cluster, fw.registry, ctrl)
    planner = planner_walltime(launches, rec)
    placements = [sched_placement(plugin, n)
                  for n in range(len(SCHED_PERIODS))
                  for plugin in SCHED_PLUGINS]
    recalcs = [sched_recalculation(n + 1) for n in range(len(SCHED_PERIODS))]
    check(len(placements) == 15 and len(recalcs) == 5,
          f"Fig. 16: {len(placements)} placement and {len(recalcs)} "
          "recalculation rows")
    check(all(None not in r["nodes"] for r in placements),
          "Fig. 16: a placement left a pod unplaced")
    emit("paper_figures_fig16", note="host time of the card's machine; "
         "no kernel on this path", placements=placements,
         recalculations=recalcs)
    summary = figure_summary(got)
    summary["rotation_J1"] = {pol: dict(worst_link_score=v)
                              for pol, v in worst.items()}
    summary["rotation_planner_F4"] = planner
    summary["fig16_ms_per_pod"] = {
        f"fig16_sched_{r['plugin']}_{r['existing_jobs']}jobs": r["ms_per_pod"]
        for r in placements}
    summary["fig16_recalc_s"] = {f"fig16_recalc_{r['jobs']}jobs": r["host_s"]
                                 for r in recalcs}
    out = dict(seconds=time.perf_counter() - t_phase, **totals, **summary)
    emit("paper_figures_summary", **out)
    return out


def _frozen(obj) -> bool:
    return dataclasses.is_dataclass(obj) and \
        type(obj).__dataclass_params__.frozen


def phase_robustness(launches, rec: Recorder) -> dict:
    """``bench_robustness``'s grid (:func:`robustness_grids`) through
    :func:`run_grids`: its 120 CPU twins submitted first to a pool of
    :func:`twin_workers` processes that runs them beside the card side.
    One line a run, one a point (the bench's rows, which must pass
    ``validate_robustness_dict``), then the summary."""
    t_phase = time.perf_counter()
    # the trace axis first: its card side (~110 s) covers the workers'
    # start (~12 s), and its twins, the longest, go first to the pool
    grids = sorted(robustness_grids(robust_trace()),
                   key=lambda g: not g.name.startswith("trace_"))
    for g in grids:
        check(all(_frozen(s) and _frozen(s.build)
                  and _frozen(s.sim_config.telemetry) for s in g.scenarios)
              and all(_frozen(p) for p in g.policies),
              f"robustness {g.name}: a scenario, build, channel or policy "
              "is not a frozen dataclass")
        check(pickle.loads(pickle.dumps(g)) == g,
              f"robustness {g.name}: the grid does not pickle")
    workers = twin_workers()
    emit("robustness_twins", workers=workers,
         cores=len(os.sched_getaffinity(0)), nice=TWIN_NICE,
         cells=sum(len(g.scenarios) * len(g.policies) for g in grids))
    before = score_counts(launches)
    with TwinPool(grids, workers) as twins:
        got, totals = run_grids("robustness", grids, launches, rec, twins)
        pool = twins.stats()
    check(not multiprocessing.active_children(),
          f"robustness: twin workers left running: "
          f"{multiprocessing.active_children()}")
    doc = to_robustness_dict(robustness_rows(
        lambda axis, sid, x, policy, seed: got[f"{axis}_{sid}"].get(
            robust_name(axis, sid, x, seed), policy)))
    problems = validate_robustness_dict(doc)
    check(not problems, f"robustness rows: {problems}")
    check(len(doc["rows"]) == sum(len(xs) for _, _, xs in ROBUST_AXES)
          * len(ROBUST_POLICIES), f"{len(doc['rows'])} robustness rows")
    for row in doc["rows"]:
        emit("robustness_point", **row)
    # the degradation control fires under the robust policy alone
    fired = {p.name: {k: sum(r[k] for r in doc["rows"]
                             if r["policy"] == p.name)
                      for k in ("suppressed_reconfigurations",
                                "reconciliations")}
             for p in ROBUST_POLICIES}
    plain, robust = (p.name for p in ROBUST_POLICIES)
    check(all(v > 0 for v in fired[robust].values()),
          f"robustness: the robust policy's controls never fired: {fired}")
    check(not any(fired[plain].values()),
          f"robustness: the plain policy's controls fired: {fired}")
    out = dict(seconds=time.perf_counter() - t_phase, **totals,
               twin_pool=pool,
               score_launches={k: n - before[k]
                               for k, n in score_counts(launches).items()},
               controls_fired=fired, **robustness_summary(doc["rows"]))
    emit("robustness_summary", **out)
    return out


def phase_planner(launches, rec: Recorder, n_candidates: int = 8) -> dict:
    out: Dict[str, dict] = {}
    before = score_counts(launches)
    t_all = time.perf_counter()
    for sid in ("J1", "F4"):
        cluster, fw, _ = schedule_snapshot(sid)
        view = LinkView.from_registry(cluster, fw.registry)
        links = planner_links(sid, view, fw.registry)
        res_np = rotation.joint_solve(view, fw.registry, links,
                                      backend="numpy")
        with counted(launches), rec.active():
            t0 = time.perf_counter()
            res_k = rotation.joint_solve(view, fw.registry, links,
                                         backend="kernel", device=DEVICE)
            seconds = time.perf_counter() - t0
        check(res_np is not None and res_k is not None,
              f"{sid}: joint_solve returned None")
        check(np.array_equal(res_np.shifts, res_k.shifts),
              f"{sid}: kernel shifts {res_k.shifts} != numpy "
              f"{res_np.shifts}")
        check(abs(res_np.score - res_k.score) <= SCORE_TOL,
              f"{sid}: score {res_k.score} vs {res_np.score}")
        out[sid] = dict(links=links, jobs=res_k.jobs,
                        shifts=[int(s) for s in res_k.shifts],
                        score=res_k.score, feasible=bool(res_k.feasible),
                        seconds=seconds)
    # a Score phase's candidate batch: one family, one stacked launch
    cluster, fw, _ = schedule_snapshot("J1")
    view = LinkView.from_registry(cluster, fw.registry)
    links = planner_links("J1", view, fw.registry)
    specs = candidate_specs(cluster, fw.registry, links, n_candidates)
    want = rotation.joint_solve_batch(specs, fw.registry, backend="numpy")
    with counted(launches), rec.active():
        t0 = time.perf_counter()
        got = rotation.joint_solve_batch(specs, fw.registry,
                                         backend="kernel", device=DEVICE)
        seconds = time.perf_counter() - t0
    for k, (a, b) in enumerate(zip(want, got)):
        check(np.array_equal(a.shifts, b.shifts),
              f"candidate {k}: kernel shifts {b.shifts} != {a.shifts}")
        check(abs(a.score - b.score) <= SCORE_TOL,
              f"candidate {k}: score {b.score} vs {a.score}")
    out["J1_batch"] = dict(candidates=n_candidates, seconds=seconds,
                           scores=[r.score for r in got])
    ran = {k: n - before[k] for k, n in score_counts(launches).items()}
    check(sum(ran.values()) > 0, "planner launched no score kernel")
    check(ran["metronome_score_multilink_batch"] > 0,
          "the candidate batch did not reach the batched score launch")
    emit("planner", seconds=time.perf_counter() - t_all,
         score_launches=ran, **out)
    return out


class CountingController(StopAndWaitController):
    """The stop-and-wait controller, counting the iteration reports."""

    def __init__(self) -> None:
        super().__init__()
        self.reports = 0

    def report_iteration(self, job: str, iter_ms: float):
        self.reports += 1
        return super().report_iteration(job, iter_ms)


def _layer_counts(cfg) -> Tuple[int, int]:
    """(flash launches a forward, RG-LRU sublayers) of a model: one launch
    an attention layer (the encoder's and the decoder's self-attention for
    encdec; cross-attention runs the plain chunked attention, as the
    reference does; xlstm has none)."""
    if cfg.family in ("dense", "moe"):
        return cfg.n_layers, 0
    if cfg.family == "encdec":
        return cfg.n_enc_layers + cfg.n_layers, 0
    if cfg.family == "xlstm":
        return 0, 0
    n_attn = cfg.n_layers // 3
    return n_attn, 2 * n_attn + cfg.n_layers % 3


@contextlib.contextmanager
def moe_kept(calls: List[Tuple[torch.Tensor, int]]):
    """While active, each prompt-length ``moe_block`` call appends its
    per-expert count of assignments kept within capacity, an (E,) tensor
    left on the device, and its number of assignments."""
    real = moe_mod.moe_block

    def counted(p, cfg, x):
        b, s, _ = x.shape
        if s > 1:
            _, _, idx = moe_mod._route(p, cfg, x)
            per_row = torch.nn.functional.one_hot(
                idx.reshape(b, -1), cfg.n_experts).sum(dim=1)
            c = moe_mod.moe_capacity(s, cfg)
            calls.append((per_row.clamp_max(c).sum(dim=0), idx.numel()))
        return real(p, cfg, x)

    moe_mod.moe_block = counted
    try:
        yield calls
    finally:
        moe_mod.moe_block = real


def moe_kept_by_layer(params, cfg, batch, n_micro: int) -> torch.Tensor:
    """(layers, experts): the assignments of ``batch`` kept within
    capacity, from one forward of each micro-batch without autograd."""
    calls: List[Tuple[torch.Tensor, int]] = []
    b = batch["tokens"].shape[0] // n_micro
    with torch.no_grad(), moe_kept(calls):
        for i in range(n_micro):
            loss_fn(params, cfg, {k: v[i * b:(i + 1) * b]
                                  for k, v in batch.items()})
    per_call = torch.stack([k for k, _ in calls])  # micro-major
    return per_call.reshape(n_micro, cfg.n_layers, -1).sum(dim=0)


def decode_continues_forward(params, cfg, prompt, full, n: int) -> float:
    """Max abs difference between ``n`` teacher-forced decode steps after a
    prefill of all but the prompt's last 256 tokens (a whole mLSTM chunk
    fewer) and ``full``, the training forward's logits over the prompt."""
    s = prompt.shape[1] - 256
    with torch.inference_mode():
        _, cache = prefill(params, cfg, prompt[:, :s], max_len=s + n)
        err = 0.0
        for t in range(s, s + n):
            logits, cache = decode_step(params, cfg, cache,
                                        prompt[:, t:t + 1])
            err = max(err, float((logits[:, 0] - full[:, t]).abs().max()))
    return err


def phase_serve(launches, rec: Recorder, spec: dict = SERVE,
                name: str = "serve") -> dict:
    """Serve ``spec``'s traffic at full width; each batch's prefill must
    launch flash once an attention layer (encdec: the encoder's
    bidirectional, the decoder's causal) and RG-LRU once a recurrent
    sublayer."""
    torch.cuda.empty_cache()  # the models of earlier phases are gone
    cfg = model_configs.get_config(spec["arch"])
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(spec["seed"])
    params = init_model(cfg, gen, DEVICE)
    prompts = make_prompts(cfg, spec["requests"], spec["batch"],
                           spec["prompt_len"], gen, DEVICE)
    frames = make_frames(cfg, spec["requests"], spec["batch"],
                         spec["prompt_len"], gen, DEVICE)
    first = None if frames is None else frames[:1]
    _sync()
    init_s = time.perf_counter() - t0
    n_params = param_count(params)
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    timing: Dict[str, float] = {}
    t0 = time.perf_counter()
    kept: List[Tuple[torch.Tensor, int]] = []
    with moe_kept(kept):
        serve_requests(params, cfg, prompts[:1], spec["warmup_gen"],
                       IterationReporter(None, "warm-up", 1), first)
    timing["warmup"] = time.perf_counter() - t0
    ctl = CountingController()
    reporter = IterationReporter(ctl, f"serve-{spec['arch']}", priority=1)
    torch.cuda.reset_peak_memory_stats()
    path: Dict[str, int] = {}
    with counted(path), rec.active():
        t0 = time.perf_counter()
        res = serve_requests(params, cfg, prompts, spec["gen"], reporter,
                             frames)
        seconds = time.perf_counter() - t0
    for w, n in path.items():
        launches[w] = launches.get(w, 0) + n
    peak = torch.cuda.max_memory_allocated()
    n_batches = len(prompts)
    steps = spec["gen"] - 1
    n_attn, n_rg = _layer_counts(cfg)
    check(res.finite, f"{name}: a logit is not finite")
    check(path["flash_attention_fwd"] == n_attn * n_batches,
          f"{name}: {path['flash_attention_fwd']} flash launches, "
          f"expected {n_attn * n_batches}")
    check(path["rg_lru_pallas"] == n_rg * n_batches,
          f"{name}: {path['rg_lru_pallas']} RG-LRU launches, "
          f"expected {n_rg * n_batches}")
    # launches by the causal flag the recorded calls passed
    by_mask = {"causal": 0, "bidirectional": 0}
    for shape, n in rec.counts["flash_attention"].items():
        causal = bool(rec.calls["flash_attention"][shape][0][3])
        by_mask["causal" if causal else "bidirectional"] += n
    if cfg.family == "encdec":
        want = {"causal": cfg.n_layers * n_batches,
                "bidirectional": cfg.n_enc_layers * n_batches}
        check(by_mask == want, f"{name}: flash launches by mask {by_mask}, "
                               f"expected {want}")
    check(ctl.reports == n_batches * steps,
          f"{name}: the controller received {ctl.reports} reports, "
          f"expected {n_batches * steps}")
    check(all(t.shape == (spec["batch"], spec["gen"]) for t in res.tokens),
          f"{name}: generated tokens of the wrong shape")

    # forward over the first batch's prompts, held against prefill's
    # last-position logits; its launches are counted apart
    t0 = time.perf_counter()
    for w in MODEL_WRAPPERS:
        w.launches = 0
    with torch.inference_mode():
        full, _ = forward(params, cfg, prompts[0],
                          frames=None if frames is None else frames[0])
        fwd_err = float((full[:, -1] - res.prefill_logits[0][:, 0])
                        .abs().max())
        check(bool(torch.isfinite(full[:, -1]).all()),
              "forward: a logit is not finite")
    fwd_launches = {w.__name__: w.launches for w in MODEL_WRAPPERS}
    check(fwd_err <= LOGIT_TOL,
          f"forward vs prefill last logits: max abs err {fwd_err} > "
          f"{LOGIT_TOL}")
    decode_err = None
    if spec.get("decode_check"):
        decode_err = decode_continues_forward(params, cfg, prompts[0], full,
                                              spec["decode_check"])
        check(decode_err <= LOGIT_TOL,
              f"{name}: decode after prefill vs forward: max abs err "
              f"{decode_err} > {LOGIT_TOL}")
    del full
    timing["forward_checks"] = time.perf_counter() - t0

    # where a batch's time goes: one batch under the profiler
    t0 = time.perf_counter()
    with torch.inference_mode():
        busy = device_busy_share(
            lambda: serve_requests(params, cfg, prompts[:1],
                                   spec["profile_gen"],
                                   IterationReporter(None, "profile", 1),
                                   first),
            f"profiled run of one batch, prefill and "
            f"{spec['profile_gen'] - 1} decode steps")
    timing["profile"] = time.perf_counter() - t0
    for w in MODEL_WRAPPERS:
        w.launches = 0

    step_ms = sorted(1e3 * t for t in res.step_s)
    n_tok = sum(t.numel() for t in res.tokens)
    out = dict(arch=cfg.name, params=n_params, param_bytes=n_bytes,
               dtype=str(cfg.dtype), requests=spec["requests"],
               batch=spec["batch"], prompt_len=spec["prompt_len"],
               frames=None if frames is None else list(frames[0].shape),
               gen=spec["gen"], init_seconds=init_s, seconds=seconds,
               prefill_ms=[1e3 * t for t in res.prefill_s],
               decode_step_ms_median=statistics.median(step_ms),
               decode_step_ms_p90=step_ms[int(0.9 * (len(step_ms) - 1))],
               decode_steps=len(step_ms),
               tokens=n_tok, tokens_per_s=n_tok / seconds,
               prompt_tokens_per_s=spec["requests"] * spec["prompt_len"]
               / sum(res.prefill_s),
               decode_tokens_per_s=spec["batch"] * len(step_ms)
               / sum(res.step_s),
               flash_launches=path["flash_attention_fwd"],
               flash_launches_by_mask=by_mask,
               rg_lru_launches=path["rg_lru_pallas"],
               controller_reports=ctl.reports,
               peak_memory_bytes=peak,
               forward_vs_prefill_max_abs_err=fwd_err,
               decode_vs_forward_max_abs_err=decode_err,
               forward_launches=fwd_launches, device_busy=busy,
               phase_seconds=timing)
    if kept:
        n = sum(a for _, a in kept)
        out["moe_kept_share_warmup_prefill"] = float(
            sum(k.sum() for k, _ in kept)) / n
        out["moe_assignments_warmup_prefill"] = n
    emit(name, **out)
    return out


def _train_batch(ds: SyntheticLM, step: int, cfg) -> Dict[str, torch.Tensor]:
    """``ds``'s batch ``step`` on the card; an encdec model's also carries
    stub frames, (B, S // enc_frames_ratio, d_model) float32 from a
    generator seeded by the step."""
    batch = {k: torch.as_tensor(v, device=DEVICE)
             for k, v in ds.batch_at(step).items()}
    if cfg.family == "encdec":
        gen = torch.Generator(device=DEVICE).manual_seed(
            ds.seed * 1_000_003 + step)
        batch["frames"] = torch.randn(
            (ds.global_batch, ds.seq_len // cfg.enc_frames_ratio,
             cfg.d_model), generator=gen, device=DEVICE)
    return batch


def _train_flops(cfg, params, seq: int, seqs: int) -> int:
    """Model FLOPs of one training step, no remat: 6 x each weight x the
    tokens that pass it (the parameters less the embedding table; a routed
    expert's weights at top_k / n_experts of the tokens; the encoder's over
    the frames) plus, per sequence, 12 D H over the unmasked (q, k) pairs
    of each attention layer (Q.K^T and P.V, forward and backward): causal
    self-attention, the encoder's bidirectional attention over the frames
    and the decoder's cross-attention to them.  The xLSTM cells' recurrent
    products are not counted."""
    def numel(tree) -> int:
        return sum(t.numel() for t in _leaves(tree))

    tokens = seq * seqs
    weights = numel(params) - params["embed"].numel()
    flops = 0
    if cfg.family == "moe":
        routed = numel({k: v for k, v in params["layers"]["moe"].items()
                        if k != "router"})
        weights -= routed
        flops += 6 * routed * tokens * cfg.top_k // cfg.n_experts
    self_attn_layers = {"xlstm": 0, "griffin": _layer_counts(cfg)[0]}.get(
        cfg.family, cfg.n_layers)
    pairs = _unmasked_pairs(seq, True, cfg.window) * self_attn_layers
    if cfg.family == "encdec":
        frames = seq // cfg.enc_frames_ratio
        enc = numel(params["enc"]) + numel(params["ln_enc"])
        weights -= enc
        flops += 6 * enc * frames * seqs
        pairs += (_unmasked_pairs(frames, False, 0) * cfg.n_enc_layers
                  + seq * frames * cfg.n_layers)
    flops += 6 * weights * tokens
    return flops + 12 * cfg.head_dim * cfg.n_heads * pairs * seqs


def phase_train(launches, rec: Recorder, spec: dict = TRAIN,
                name: str = "train") -> dict:
    """Train ``spec``'s model at full width (its depth cut to
    ``spec["n_layers"]`` where given) on ``spec``'s traffic."""
    torch.cuda.empty_cache()  # the serving model is gone with its phase
    cfg = full = model_configs.get_config(spec["arch"])
    if spec.get("n_layers"):
        cfg = dataclasses.replace(full, n_layers=spec["n_layers"])
    check(cfg.remat and cfg.remat_policy == "nothing",
          f"{name}: the config does not recompute every layer")
    n_micro, steps = spec["n_micro"], spec["steps"]
    opt_cfg = AdamWConfig()  # the reference's defaults, float32 moments
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(spec["seed"])
    state = init_train_state(cfg, opt_cfg, gen, DEVICE)
    _sync()
    init_s = time.perf_counter() - t0
    n_params = param_count(state.params)
    ds = SyntheticLM(cfg.vocab, spec["seq"], spec["batch"],
                     seed=spec["seed"])
    step_fn = build_train_step(cfg, opt_cfg, n_micro)
    ctl = CountingController()
    job = f"train-{spec['arch']}"
    gate = CommGate(ctl, job=job)
    reporter = IterationReporter(ctl, job, priority=1)

    losses, grad_norms, auxes, step_s = [], [], [], []

    def one_step(step: int) -> None:
        nonlocal state
        batch = _train_batch(ds, step, cfg)
        gate.wait_for_slot()
        t = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))  # waits for the device
        grad_norms.append(float(metrics["grad_norm"]))
        auxes.append(float(metrics["aux"]))
        step_s.append(time.perf_counter() - t)
        reporter.report(step_s[-1])

    timing: Dict[str, float] = {}
    t0 = time.perf_counter()
    p0 = [p.clone() for p in _leaves(state.params)]
    routed = None
    if cfg.family == "moe":
        routed = moe_kept_by_layer(state.params, cfg, _train_batch(ds, 0, cfg),
                                   n_micro)
    one_step(0)  # warm-up; its gradients are checked through the moments
    # m = (1 - b1) * clipped gradient after the first step
    zero = [i for i, m in enumerate(_leaves(state.opt["m"]))
            if not float(torch.linalg.vector_norm(m)) > 0.0]
    check(not zero, f"{name}: {len(zero)} parameter leaves got a zero "
                    f"gradient in the first step (leaf indices {zero})")
    experts = None
    if routed is not None:
        # each (layer, expert) slice of the expert leaves has a gradient
        # exactly where the step-0 batch kept a token for that expert
        experts = {"no_token_kept": int((routed == 0).sum()),
                   "of": routed.numel()}
        for k in ("w_gate", "w_up", "w_down"):
            m = state.opt["m"]["layers"]["moe"][k].flatten(2)
            moved = m.norm(dim=-1) > 0
            experts[f"{k}_with_gradient"] = int(moved.sum())
            check(torch.equal(moved, routed > 0),
                  f"{name}: {k}: (layer, expert) slices with a gradient "
                  f"{int(moved.sum())}, with a token kept "
                  f"{int((routed > 0).sum())}, not the same slices")
    witness = first_step_witness(state, p0, _train_batch(ds, 0, cfg), cfg,
                                 opt_cfg, losses[0], grad_norms[0], n_micro)
    del p0
    timing["warmup_and_witness"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()  # the timed steps' peak
    path: Dict[str, int] = {}
    with counted(path), rec.active():
        for step in range(1, 1 + steps):
            one_step(step)
    for w, n in path.items():
        launches[w] = launches.get(w, 0) + n
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses + grad_norms + auxes),
          f"{name}: a loss, grad norm or aux loss is not finite: {losses} "
          f"{grad_norms} {auxes}")
    if cfg.family == "moe":
        check(all(a > 0.0 for a in auxes),
              f"{name}: a zero MoE aux loss: {auxes}")
    n_attn, n_rg = _layer_counts(cfg)
    want = {"flash_attention_fwd": 2 * n_attn * n_micro * steps,
            "_flash_attention_bwd": n_attn * n_micro * steps,
            "rg_lru_pallas": 2 * n_rg * n_micro * steps,
            "_rg_lru_pallas_bwd": n_rg * n_micro * steps}
    for w, n in want.items():
        check(path[w] == n, f"{name}: {path[w]} {w} launches, expected {n}")
    check(ctl.reports == 1 + steps,
          f"{name}: the controller received {ctl.reports} reports, "
          f"expected {1 + steps}")

    timing["timed_steps"] = time.perf_counter() - t0
    # the loss check: the step-0 batch again, no warm-up
    t0 = time.perf_counter()
    check_fn = build_train_step(cfg, AdamWConfig(lr=spec["check_lr"],
                                                 warmup_steps=0), n_micro)
    batch0 = _train_batch(ds, 0, cfg)
    check_losses = []
    for _ in range(4):
        state, metrics = check_fn(state, batch0)
        check_losses.append(float(metrics["loss"]))
    check(all(math.isfinite(x) for x in check_losses),
          f"{name}: repeated-batch losses {check_losses}")
    timing["loss_check"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for w in MODEL_WRAPPERS:
        w.launches = 0
    busy = train_step_profile(lambda: check_fn(state, batch0),
                              spec["seq"], cfg.vocab)
    timing["profile"] = time.perf_counter() - t0
    for w in MODEL_WRAPPERS:
        w.launches = 0

    tokens = spec["batch"] * spec["seq"]
    med = statistics.median(step_s[1:])
    flops = _train_flops(cfg, state.params, spec["seq"], spec["batch"])
    timed = sorted(1e3 * t for t in step_s[1:])
    out = dict(arch=cfg.name, params=n_params, dtype=str(cfg.dtype),
               layers=cfg.n_layers,
               depth_cut=(f"{cfg.n_layers} of {full.n_layers} layers"
                          if cfg.n_layers != full.n_layers else None),
               moment_dtype=str(opt_cfg.moment_dtype), remat=cfg.remat,
               seq=spec["seq"], batch=spec["batch"], n_micro=n_micro,
               init_seconds=init_s, warmup_step_ms=1e3 * step_s[0],
               step_ms=timed, step_ms_median=1e3 * med,
               step_ms_p90=timed[int(0.9 * (len(timed) - 1))],
               tokens_per_s=tokens / med, losses=losses,
               grad_norms=grad_norms, aux=auxes,
               experts=experts,
               check_lr=spec["check_lr"],
               repeated_batch_losses=check_losses, first_step=witness,
               peak_memory_bytes=peak, model_flops_per_step=flops,
               mfu=flops / (med * PEAK_BF16_OPS_PER_S),
               launches={k: path[k] for k in want},
               launches_per_step={k: path[k] // steps for k in want},
               controller_reports=ctl.reports, device_busy=busy,
               phase_seconds=timing)
    emit(name, **out)
    check(check_losses[-1] < check_losses[0],
          f"{name}: the repeated batch's loss did not fall: {check_losses}")
    lo, hi = FIRST_STEP_RATIO
    check(witness["predicted_dloss"] < 0.0 and lo <= witness["ratio"] <= hi,
          f"{name}: the first step's loss change is not its first-order "
          f"prediction within {FIRST_STEP_RATIO}: {witness}")
    by_source = busy.get("device_ms_by_source")
    check(by_source is not None and by_source["attention_ref_bmm"] == 0.0,
          f"{name}: plain attention over (seq, seq) scores on the card: "
          f"{by_source}")
    if name in DOTS_PHASES:
        phase_train_dots(launches, state, ds, spec, cfg, out, f"{name}_dots")
    del state
    torch.cuda.empty_cache()
    return out


def phase_train_dots(launches, state, ds: SyntheticLM, spec: dict, cfg,
                     nothing: dict, name: str) -> dict:
    """The state a train phase left, its model and traffic, under
    ``remat_policy="dots"``: the first micro-batch's loss and every
    gradient leaf bit for bit with ``"nothing"``'s on the same parameters
    and batch, the kernels launched as often a micro-batch and a step,
    then a warm-up and ``DOTS_STEPS`` timed steps and one profiled step.
    ``nothing`` is the train phase's line, for the comparison."""
    dots = dataclasses.replace(cfg, remat_policy="dots")
    check(cfg.remat and cfg.remat_policy == "nothing",
          f"{name}: the train phase's config is not remat 'nothing'")
    n_micro = spec["n_micro"]
    timing: Dict[str, float] = {}
    t0 = time.perf_counter()
    batch0 = _train_batch(ds, 0, cfg)
    b = batch0["tokens"].shape[0] // n_micro
    micro = {k: v[:b] for k, v in batch0.items()}

    def grads(c, path: Dict[str, int]):
        xs = [p.detach().requires_grad_()
              for p in _tree.leaves(state.params)]
        with counted(path):
            loss, _ = loss_fn(_tree.rebuild(state.params, xs), c, micro)
            g = torch.autograd.grad(loss, xs)
            _sync()
        return loss.detach(), g

    # one gradient set on the card at a time: the first goes to the host
    w_nothing: Dict[str, int] = {}
    w_dots: Dict[str, int] = {}
    loss0, g = grads(cfg, w_nothing)
    want_g = [t.cpu() for t in g]
    del g
    loss1, g = grads(dots, w_dots)
    n_leaves = len(want_g)
    differ = [i for i, (a, w) in enumerate(zip(g, want_g))
              if not torch.equal(a.cpu(), w)]
    del g, want_g
    torch.cuda.empty_cache()
    timing["witness"] = time.perf_counter() - t0
    n_attn, n_rg = _layer_counts(cfg)
    per_micro = {"flash_attention_fwd": 2 * n_attn,
                 "_flash_attention_bwd": n_attn,
                 "rg_lru_pallas": 2 * n_rg, "_rg_lru_pallas_bwd": n_rg}
    witness = dict(loss_nothing=float(loss0), loss_dots=float(loss1),
                   loss_bit_exact=bool(torch.equal(loss0, loss1)),
                   leaves=n_leaves, leaves_differ=differ,
                   launches_nothing={w: w_nothing[w] for w in per_micro},
                   launches_dots={w: w_dots[w] for w in per_micro})
    check(witness["loss_bit_exact"] and not differ,
          f"{name}: the first micro-batch's loss or gradients under 'dots' "
          f"differ from 'nothing': {witness}")
    check(all(w_nothing[w] == w_dots[w] == n for w, n in per_micro.items()),
          f"{name}: a micro-batch's launches: {witness}, expected "
          f"{per_micro}")

    t0 = time.perf_counter()
    step_fn = build_train_step(dots, AdamWConfig(), n_micro)
    step_s, losses = [], []

    def one_step(step: int) -> None:
        nonlocal state
        batch = _train_batch(ds, step, cfg)
        t = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))  # waits for the device
        step_s.append(time.perf_counter() - t)

    one_step(1)  # warm-up
    torch.cuda.reset_peak_memory_stats()  # the timed steps' peak
    path: Dict[str, int] = {}
    with counted(path):
        for step in range(2, 2 + DOTS_STEPS):
            one_step(step)
    for w, n in path.items():
        launches[w] = launches.get(w, 0) + n
    peak = torch.cuda.max_memory_allocated()
    timing["steps"] = time.perf_counter() - t0
    want = {w: n * n_micro * DOTS_STEPS for w, n in per_micro.items()}
    for w, n in want.items():
        check(path[w] == n, f"{name}: {path[w]} {w} launches, expected {n}")
    check(all(math.isfinite(x) for x in losses),
          f"{name}: a loss is not finite: {losses}")
    check(peak < torch.cuda.get_device_properties(0).total_memory,
          f"{name}: peak {peak} bytes")
    t0 = time.perf_counter()
    busy = train_step_profile(lambda: step_fn(state, batch0), spec["seq"],
                              cfg.vocab)
    timing["profile"] = time.perf_counter() - t0
    for w in MODEL_WRAPPERS:
        w.launches = 0

    tokens = spec["batch"] * spec["seq"]
    timed = sorted(1e3 * t for t in step_s[1:])
    med = statistics.median(step_s[1:])
    flops = nothing["model_flops_per_step"]  # remat is not counted
    out = dict(arch=cfg.name, layers=cfg.n_layers,
               remat_policy=dots.remat_policy, seq=spec["seq"],
               batch=spec["batch"], n_micro=n_micro, witness=witness,
               warmup_step_ms=1e3 * step_s[0], step_ms=timed,
               step_ms_median=1e3 * med,
               step_ms_p90=timed[int(0.9 * (len(timed) - 1))],
               tokens_per_s=tokens / med, losses=losses,
               peak_memory_bytes=peak, model_flops_per_step=flops,
               mfu=flops / (med * PEAK_BF16_OPS_PER_S),
               launches_per_step={w: path[w] // DOTS_STEPS for w in want},
               device_busy=busy,
               nothing=dict(step_ms_median=nothing["step_ms_median"],
                            peak_memory_bytes=nothing["peak_memory_bytes"],
                            device_ms_by_source=nothing["device_busy"].get(
                                "device_ms_by_source")),
               phase_seconds=timing)
    emit(name, **out)
    by_source = busy.get("device_ms_by_source")
    check(by_source is not None and by_source["attention_ref_bmm"] == 0.0,
          f"{name}: plain attention over (seq, seq) scores on the card: "
          f"{by_source}")
    return out


def first_step_witness(state, p0: List[torch.Tensor], batch, cfg, opt_cfg,
                       loss0: float, gnorm: float, n_micro: int) -> dict:
    """The first step's loss change on its own batch against its
    first-order prediction g . (p1 - p0), the gradient g read off the
    first moments (one step from zero leaves m = (1 - b1) * clip * g) and
    p0 the parameters before the step.  Adam's first step moves every
    element that bf16 can move by about lr against its gradient's sign, so
    the prediction is about -lr times ||g||_1 over the moved elements:
    ``moved_share`` and ``grad_l1`` say how large that is."""
    g_scale = (1.0 - opt_cfg.b1) * min(1.0, opt_cfg.grad_clip / gnorm)
    pred, l1, moved, n = 0.0, 0.0, 0, 0
    for p1, q, m in zip(_leaves(state.params), p0, _leaves(state.opt["m"])):
        d = p1.float() - q.float()
        pred += float(torch.dot(m.flatten(), d.flatten()))
        l1 += float(m.abs().sum())
        moved += int(torch.count_nonzero(d))
        n += d.numel()
        del d
    b = batch["tokens"].shape[0] // n_micro
    with torch.no_grad():
        loss1 = sum(float(loss_fn(state.params, cfg, {
            k: v[i * b:(i + 1) * b] for k, v in batch.items()})[0])
            for i in range(n_micro)) / n_micro
    pred /= g_scale
    return dict(loss_before=loss0, loss_after=loss1,
                observed_dloss=loss1 - loss0, predicted_dloss=pred,
                ratio=(loss1 - loss0) / pred if pred else float("nan"),
                moved_share=moved / n, grad_l1=l1 / g_scale)



# ---------------------------------------------------------------------------
# sharded paths: DTensor on the 1 x 1 mesh, the elastic re-mesh, the dry run
# ---------------------------------------------------------------------------

# train_dense's model, weights (seed) and batches, 2 steps plain and 2 on
# DTensor parameters over the 1-rank NCCL mesh
TRAIN_SHARDED = dict(TRAIN_DENSE, steps=2)
# Llama-3-8B at full width and depth, one batch of 4 requests, 8 generated
# tokens: prompts of 4088 so that prompt and generated tokens fill whole
# 1024-token chunks of the decode's attention
SERVE_SHARDED = dict(SERVE_DENSE, requests=4, prompt_len=4088, gen=8)
# the dry run's cells on the fake 16 x 16 process group (one process each,
# all started together), and the link rate the Metronome core is handed
# (RecurrentGemma at prefill_32k counts ~10x the model's FLOPs: its
# chunked local attention computes every 1024-key chunk of 32,768 for a
# 2048-token window, and its 10 heads do not split over 16 ranks, so the
# ratio check cannot hold there; train_4k keeps the family, PERF.md)
DRYRUN_CELLS = (("llama3-8b", "train_4k"), ("qwen2-moe-a2.7b", "train_4k"),
                ("recurrentgemma-2b", "train_4k"))
DRYRUN_RATIO = (0.3, 1.5)  # model FLOPs over counted FLOPs, per rank
DRYRUN_TIMEOUT_S = 300


def _host_mesh():
    """The 1 x 1 ("data", "model") mesh over a world-size-1 NCCL group."""
    return make_host_mesh(1, 1, device=DEVICE)


def _full(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _train_steps(cfg, spec, sharded: bool, rec: Optional[Recorder] = None):
    """``spec["steps"]`` steps of ``spec``'s traffic from the seed's
    weights, on plain tensors or on DTensors over the 1 x 1 mesh, the
    kernels' inputs kept in ``rec`` where given: (losses, step ms, final
    parameters (plain), launches by wrapper)."""
    opt_cfg = AdamWConfig()
    gen = torch.Generator(device=DEVICE).manual_seed(spec["seed"])
    params = init_model(cfg, gen, DEVICE)
    ds = SyntheticLM(cfg.vocab, spec["seq"], spec["batch"],
                     seed=spec["seed"])
    specs = logical_specs(cfg) if sharded else None
    ctx = use_rules(_host_mesh()) if sharded else contextlib.nullcontext()
    losses, step_ms, path = [], [], {}
    with ctx:
        if sharded:
            params = shard_tree(params, specs)
        state = TrainState(params, adamw_init(opt_cfg, params),
                           torch.zeros((), dtype=torch.int32, device=DEVICE))
        step_fn = build_train_step(cfg, opt_cfg, spec["n_micro"],
                                   param_specs=specs)
        recording = rec.active() if rec else contextlib.nullcontext()
        with counted(path), recording:
            for step in range(spec["steps"]):
                batch = _train_batch(ds, step, cfg)
                _sync()
                t0 = time.perf_counter()
                state, metrics = step_fn(state, batch)
                losses.append(_full(metrics["loss"]).clone())
                _sync()
                step_ms.append(1e3 * (time.perf_counter() - t0))
        final = [_full(p).clone() for p in _leaves(state.params)]
    del state, params
    torch.cuda.empty_cache()
    return losses, step_ms, final, path


def phase_train_sharded(launches, rec: Recorder,
                        rec_griffin: Recorder) -> dict:
    """train_dense's first steps on DTensor parameters over the 1-rank
    mesh, through ``build_train_step(param_specs=...)``, against the same
    steps on plain tensors: the losses and every parameter leaf bit for
    bit, flash launched as often.  Then the same on the griffin smoke
    config (head dim 64 for the kernel), whose path runs the RG-LRU
    kernel and its backward on DTensor blocks.  The DTensor runs' kernel
    inputs go to ``rec`` and ``rec_griffin`` (the kernel cases hold them
    against the plain versions)."""
    torch.cuda.empty_cache()
    spec = TRAIN_SHARDED
    cfg = dataclasses.replace(model_configs.get_config(spec["arch"]),
                              n_layers=spec["n_layers"])
    t0 = time.perf_counter()
    l0, ms0, p0, path0 = _train_steps(cfg, spec, sharded=False)
    l1, ms1, p1, path1 = _train_steps(cfg, spec, sharded=True, rec=rec)
    for w, n in path1.items():
        launches[w] = launches.get(w, 0) + n
    seconds = time.perf_counter() - t0
    per_step = cfg.n_layers * spec["n_micro"] * spec["steps"]
    for w, n in (("flash_attention_fwd", 2 * per_step),
                 ("_flash_attention_bwd", per_step)):
        check(path0[w] == path1[w] == n,
              f"train_sharded: {w} launches plain {path0[w]} sharded "
              f"{path1[w]}, expected {n}")
    loss_equal = all(torch.equal(a, b) for a, b in zip(l0, l1))
    differ = [i for i, (a, b) in enumerate(zip(p0, p1))
              if not torch.equal(a, b)]
    max_rel = max((float((a.float() - b.float()).abs().max()
                         / b.float().abs().max().clamp_min(1e-30))
                   for a, b in zip(p0, p1)), default=0.0)
    check(loss_equal and not differ,
          f"train_sharded: not bit for bit: losses {l0} {l1}, leaves "
          f"{differ} differ (max rel {max_rel})")
    del p0, p1

    small = dataclasses.replace(
        model_configs.get_smoke_config("recurrentgemma-2b"), d_head=64)
    small_spec = dict(spec, seq=256, batch=4, steps=1)
    s0, _, q0, g0 = _train_steps(small, small_spec, sharded=False)
    s1, _, q1, g1 = _train_steps(small, small_spec, sharded=True,
                                 rec=rec_griffin)
    for w, n in g1.items():
        launches[w] = launches.get(w, 0) + n
    n_attn, n_rg = _layer_counts(small)
    want = {"flash_attention_fwd": 2 * n_attn * spec["n_micro"],
            "_flash_attention_bwd": n_attn * spec["n_micro"],
            "rg_lru_pallas": 2 * n_rg * spec["n_micro"],
            "_rg_lru_pallas_bwd": n_rg * spec["n_micro"]}
    for w, n in want.items():
        check(g0[w] == g1[w] == n,
              f"train_sharded griffin: {w} launches plain {g0[w]} sharded "
              f"{g1[w]}, expected {n}")
    check(torch.equal(s0[0], s1[0])
          and all(torch.equal(a, b) for a, b in zip(q0, q1)),
          "train_sharded griffin: the DTensor step differs from the plain "
          "one")
    # the same step under remat_policy="dots", plain and on DTensors: the
    # products it keeps are DTensors there; both bit for bit with "nothing"
    dots = dataclasses.replace(small, remat_policy="dots")
    s2, _, q2, g2 = _train_steps(dots, small_spec, sharded=False)
    s3, _, q3, g3 = _train_steps(dots, small_spec, sharded=True)
    for w, n in g3.items():
        launches[w] = launches.get(w, 0) + n
    for w, n in want.items():
        check(g2[w] == g3[w] == n,
              f"train_sharded griffin dots: {w} launches plain {g2[w]} "
              f"sharded {g3[w]}, expected {n}")
    check(all(torch.equal(s0[0], s[0]) for s in (s2, s3))
          and all(torch.equal(a, b) and torch.equal(a, c)
                  for a, b, c in zip(q0, q2, q3)),
          "train_sharded griffin: a 'dots' step, plain or on DTensors, "
          "differs from the 'nothing' one")
    out = dict(arch=cfg.name, layers=cfg.n_layers, seq=spec["seq"],
               batch=spec["batch"], n_micro=spec["n_micro"],
               steps=spec["steps"], mesh="1x1 (NCCL, world size 1)",
               losses=[float(x) for x in l1], bit_exact=True,
               step_ms_plain=ms0, step_ms_dtensor=ms1,
               dtensor_overhead_ms=[b - a for a, b in zip(ms0, ms1)],
               flash_launches=path1["flash_attention_fwd"],
               flash_bwd_launches=path1["_flash_attention_bwd"],
               griffin_smoke=dict(loss=float(s1[0]),
                                  launches={w: g1[w] for w in want},
                                  bit_exact=True),
               griffin_smoke_dots=dict(loss=float(s3[0]),
                                       launches={w: g3[w] for w in want},
                                       bit_exact=True),
               seconds=seconds)
    emit("train_sharded", **out)
    return out


def _serve_trace(params, cfg, prompts, gen: int, tokens=None):
    """Prefill ``prompts`` and decode ``gen - 1`` steps, teacher-forced by
    ``tokens`` (B, gen) where given, else greedy: (prefill logits, decode
    logits a step, tokens, prefill ms, decode ms a step)."""
    with torch.no_grad():
        _sync()
        t0 = time.perf_counter()
        logits, cache = prefill(params, cfg, prompts,
                                max_len=prompts.shape[1] + gen)
        first = _full(logits).float()
        _sync()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        tok = (first[:, -1].argmax(dim=-1, keepdim=True) if tokens is None
               else tokens[:, :1])
        toks, steps, step_ms = [tok], [], []
        for i in range(gen - 1):
            t0 = time.perf_counter()
            logits, cache = decode_step(params, cfg, cache, tok)
            lg = _full(logits).float()
            _sync()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            steps.append(lg)
            tok = (lg[:, -1].argmax(dim=-1, keepdim=True) if tokens is None
                   else tokens[:, i + 1:i + 2])
            toks.append(tok)
    return first, steps, torch.cat(toks, dim=1), prefill_ms, step_ms


SERVE_SHARDED_CALLS = 3  # timed calls each way, after a warm-up


def phase_serve_sharded(launches, rec: Recorder) -> dict:
    """Llama-3-8B at full width and depth served on plain tensors and on
    DTensor parameters over the 1-rank mesh, the same weights, prompts and
    (teacher-forced) tokens: prefill and decode logits within LOGIT_TOL,
    flash once a layer in both prefills; the DTensor run's kernel inputs
    go to ``rec``.  Each way warms up at the timed length, then times
    SERVE_SHARDED_CALLS calls (the first counted and checked): the median
    prefill, the decode steps of all of them."""
    torch.cuda.empty_cache()
    spec = SERVE_SHARDED
    cfg = model_configs.get_config(spec["arch"])
    gen = torch.Generator(device=DEVICE).manual_seed(spec["seed"])
    params = init_model(cfg, gen, DEVICE)
    prompts = make_prompts(cfg, spec["requests"], spec["batch"],
                           spec["prompt_len"], gen, DEVICE)[0]

    def more(p, tokens):
        """The timed calls after the first: prefill ms, decode ms."""
        pre, dec = [], []
        for _ in range(SERVE_SHARDED_CALLS - 1):
            *_, pre_ms, dec_ms = _serve_trace(p, cfg, prompts, spec["gen"],
                                              tokens=tokens)
            pre.append(pre_ms)
            dec.extend(dec_ms)
        return pre, dec

    _serve_trace(params, cfg, prompts, spec["gen"])  # warm-up
    p0: Dict[str, int] = {}
    with counted(p0):
        pre0, dec0, toks, pre0_ms, dec0_ms = _serve_trace(
            params, cfg, prompts, spec["gen"])
    pre_more, dec_more = more(params, toks)
    pre0_all, dec0_ms = [pre0_ms] + pre_more, dec0_ms + dec_more
    with use_rules(_host_mesh()):
        dparams = shard_tree(params, logical_specs(cfg))
        del params
        torch.cuda.empty_cache()
        _serve_trace(dparams, cfg, prompts, spec["gen"], tokens=toks)
        p1: Dict[str, int] = {}
        with counted(p1), rec.active():
            pre1, dec1, _, pre1_ms, dec1_ms = _serve_trace(
                dparams, cfg, prompts, spec["gen"], tokens=toks)
        pre_more, dec_more = more(dparams, toks)
        pre1_all, dec1_ms = [pre1_ms] + pre_more, dec1_ms + dec_more
    for w, n in p1.items():
        launches[w] = launches.get(w, 0) + n
    del dparams
    torch.cuda.empty_cache()
    check(p0["flash_attention_fwd"] == p1["flash_attention_fwd"]
          == cfg.n_layers,
          f"serve_sharded: flash launches plain {p0} sharded {p1}, "
          f"expected {cfg.n_layers}")
    pre_err = float((pre0 - pre1).abs().max())
    dec_err = max(float((a - b).abs().max()) for a, b in zip(dec0, dec1))
    check(pre_err <= LOGIT_TOL and dec_err <= LOGIT_TOL,
          f"serve_sharded: logits apart by {pre_err} (prefill), {dec_err} "
          f"(decode), more than {LOGIT_TOL}")

    def stats(ms):
        s = sorted(ms)
        return dict(median=statistics.median(s),
                    p90=s[int(0.9 * (len(s) - 1))])

    out = dict(arch=cfg.name, batch=spec["batch"],
               prompt_len=spec["prompt_len"], gen=spec["gen"],
               mesh="1x1 (NCCL, world size 1)",
               warmup="one call at the timed length each way",
               prefill_ms_plain=statistics.median(pre0_all),
               prefill_ms_dtensor=statistics.median(pre1_all),
               prefill_ms_plain_calls=pre0_all,
               prefill_ms_dtensor_calls=pre1_all,
               decode_step_ms_plain=stats(dec0_ms),
               decode_step_ms_dtensor=stats(dec1_ms),
               prefill_max_abs_err=pre_err, decode_max_abs_err=dec_err,
               tolerance=LOGIT_TOL,
               flash_launches=p1["flash_attention_fwd"])
    emit("serve_sharded", **out)
    return out


def phase_elastic(launches, rec: Recorder) -> dict:
    """A failure after step 0 of the griffin smoke config (head dim 64) on
    the card: ``FaultTolerantRunner.on_failure`` with the one healthy rank
    plans a (1, 1) mesh, builds it, restores the step-1 checkpoint, and
    step 1 resumes on DTensors over that mesh; it must equal step 1 of the
    uninterrupted run bit for bit.  The resumed step's kernel inputs go to
    ``rec``."""
    import shutil
    cfg = dataclasses.replace(
        model_configs.get_smoke_config("recurrentgemma-2b"), d_head=64)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=0)
    ds = SyntheticLM(cfg.vocab, 256, 4, seed=0)
    step_fn = build_train_step(cfg, opt_cfg, 2)
    ckpt_dir = ROOT / "build" / "elastic_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    def fresh():
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        return init_train_state(cfg, opt_cfg, gen, DEVICE)

    path: Dict[str, int] = {}
    with counted(path):
        state, _ = step_fn(fresh(), _train_batch(ds, 0, cfg))
        mgr = CheckpointManager(str(ckpt_dir), async_save=False)
        mgr.save(1, state)
        state, m_ref = step_fn(state, _train_batch(ds, 1, cfg))
        want = [p.clone() for p in _leaves(state.params)]

        runner = FaultTolerantRunner(mgr, model_parallel=1, device=DEVICE)
        mesh, restored, step, decision = runner.on_failure([0], fresh())
        check(step == 1 and decision.mesh_shape == (1, 1)
              and tuple(mesh.shape) == (1, 1),
              f"elastic: resumed at {step} on {decision.mesh_shape}")
        specs = logical_specs(cfg)
        with use_rules(mesh), rec.active():
            params = shard_tree(restored.params, specs)
            opt = {"m": shard_tree(restored.opt["m"], specs),
                   "v": shard_tree(restored.opt["v"], specs),
                   "step": restored.opt["step"]}
            resumed = TrainState(params, opt, restored.step)
            resumed, m = build_train_step(cfg, opt_cfg, 2,
                                          param_specs=specs)(
                resumed, _train_batch(ds, 1, cfg))
            got = [_full(p) for p in _leaves(resumed.params)]
            loss = _full(m["loss"])
    for w, n in path.items():
        launches[w] = launches.get(w, 0) + n
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    check(torch.equal(loss, m_ref["loss"])
          and all(torch.equal(a, b) for a, b in zip(got, want)),
          "elastic: the resumed step differs from the uninterrupted one")
    out = dict(arch=cfg.name, events=runner.events,
               mesh_shape=list(decision.mesh_shape), resumed_at=step,
               loss=float(loss), bit_exact=True,
               launches={w: n for w, n in path.items() if n})
    emit("elastic", **out)
    return out


class DryRun:
    """The dry run's cells on a fake 256-rank process group, one process a
    cell (a fake group must be its process's only one), started together
    at a lower priority while the card trains (the cells need only host
    cores, and the train steps keep the card 99% busy), each writing its
    log under ``build/dryrun``; :meth:`stop` ends any still running."""

    def __init__(self) -> None:
        self.dir = ROOT / "build" / "dryrun"
        self.dir.mkdir(parents=True, exist_ok=True)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   OMP_NUM_THREADS="1")
        self.t0 = time.perf_counter()
        self.procs = []
        try:
            for arch, shape in DRYRUN_CELLS:
                out = self.dir / f"{arch}_{shape}.json"
                out.unlink(missing_ok=True)
                with open(self.dir / f"{arch}_{shape}.log", "w") as log:
                    self.procs.append((arch, shape, out, subprocess.Popen(
                        [sys.executable, "-m", "repro_torch.launch.dryrun",
                         "--arch", arch, "--shape", shape, "--mesh",
                         "single", "--out", str(out)], cwd=self.dir,
                        env=env, stdout=log, stderr=subprocess.STDOUT,
                        preexec_fn=lambda: os.nice(10))))
        except BaseException:
            self.stop()
            raise

    def stop(self) -> None:
        for *_, proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    def wait(self) -> Tuple[dict, float]:
        """Each cell's record once its process ends, and the seconds from
        the start to the last end."""
        cells = {}
        try:
            for arch, shape, out, proc in self.procs:
                proc.wait(timeout=DRYRUN_TIMEOUT_S)
                log = (self.dir / f"{arch}_{shape}.log").read_text()
                check(proc.returncode == 0,
                      f"dryrun {arch} {shape}: exit {proc.returncode}: "
                      f"{log[-2000:]}")
                cells.update(json.loads(out.read_text()))
        finally:
            self.stop()
        return cells, time.perf_counter() - self.t0


def phase_dryrun(run: DryRun) -> dict:
    """The dry run's cells (:class:`DryRun`): every cell ``ok``, the
    model's FLOPs over the counted ones within DRYRUN_RATIO, and the
    Metronome traffic each roofline gives."""
    from repro_torch.core.workload import traffic_from_roofline
    from repro_torch.launch.dryrun import LINK_BW
    cells, seconds = run.wait()
    report = {}
    for key, info in cells.items():
        check(info.get("status") == "ok",
              f"dryrun {key}: {info.get('status')}: {info.get('error')}")
        ratio = info["model_vs_counted_flops"]
        lo, hi = DRYRUN_RATIO
        check(ratio is not None and lo < ratio < hi,
              f"dryrun {key}: model over counted FLOPs {ratio} outside "
              f"{DRYRUN_RATIO}")
        r = info["roofline"]
        traffic = traffic_from_roofline(r["compute_s"], r["collective_s"],
                                        LINK_BW * 8 / 1e9)
        report[key] = dict(
            flops=info["cost"]["flops"], hbm_bytes=info["cost"]["bytes"],
            attention_hbm_bytes=info["attention_hbm_bytes"],
            collective_bytes=info["collectives"],
            model_vs_counted_flops=ratio, roofline_s=r,
            bottleneck=info["bottleneck"],
            roofline_flash_s=info["roofline_flash"],
            memory=info["memory"], n_micro=info.get("n_micro"),
            trace_s=info["trace_s"], trace_warnings=info["trace_warnings"],
            traffic=dict(period_ms=traffic.period_ms, duty=traffic.duty,
                         bw_gbps=traffic.bw_gbps))
    out = dict(mesh="16x16 (fake process group of 256 ranks)",
               constants="H100 SXM: 989e12 FLOP/s bf16, 3.35e12 B/s HBM, "
                         "450e9 B/s NVLink one way",
               cells=report, seconds=seconds)
    emit("dryrun", **out)
    return out


def _leaves(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    for v in tree.values():
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def _dev(arrays, dtypes) -> List[torch.Tensor]:
    return [torch.from_numpy(np.ascontiguousarray(a, dtype=t)).to(DEVICE)
            for a, t in zip(arrays, dtypes)]


FILL_TYPES = (np.float32, np.uint8, np.float32)


def _fill_case(inputs: List[list]) -> dict:
    """Kernel vs plain fill on a list of (demands, routes, caps) launches:
    max error (it must be 0: the kernel is bit for bit), CUDA-event times
    of the whole list, device-only time per launch, and the bound."""
    dev = [_dev(a, FILL_TYPES) for a in inputs]
    err = 0.0
    nbytes = 0
    n_ops = 0
    for d, r, c in dev:
        got = metronome_fill(d, r, c)
        want, rounds = ref._fill_rounds(d, r, c)
        _sync()
        check(bool(torch.isfinite(got).all()), "fill kernel: non-finite")
        check(torch.equal(got, want),
              f"fill kernel {tuple(r.shape)}: not bit for bit with the plain "
              f"version, max abs err {float((got - want).abs().max())}")
        err = max(err, float((got - want).abs().max()))
        bsz, f, l = r.shape
        nbytes += d.numel() * 4 + r.numel() + c.numel() * 4 + d.numel() * 4
        # per round: active counts (F*L), link shares (L), headroom (F),
        # updates (F + L), freeze test (F*L); rounds are this data's own
        n_ops += int(rounds.sum()) * (2 * f * l + 3 * f + 2 * l)
    ms = time_ms(lambda: [metronome_fill(*x) for x in dev])
    device = device_us(lambda: [metronome_fill(*x) for x in dev],
                       FILL_KERNELS)
    plain_ms = time_ms(lambda: [ref.progressive_fill_ref(*x) for x in dev],
                       reps=5, warmup=1)
    bound_ms, bound_by = _bound(nbytes, n_ops)
    return dict(launches_timed=len(dev),
                shapes=sorted({tuple(x[1].shape) for x in dev}),
                max_abs_err=err, bit_exact=err == 0.0, ms=ms, **device,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes, operations=n_ops)


def _score_library(base, bank_a, bank_b, caps) -> torch.Tensor:
    """The batched score through one library call: with u = base + A and
    v = cap - B, sum_s relu(u_as - v_bs) = (sum u_a - sum v_b
    + cdist_1(u_a, v_b)) / 2, so ``torch.cdist(p=1)`` over the C * L
    (Ra, S) x (Rb, S) batches plus O(Ra + Rb) elementwise work computes it
    (timed here as the score's yardstick; the port never calls it; the
    identity cancels large sums in float32)."""
    c, l, s = base.shape
    u = base[:, :, None, :] + bank_a
    v = caps[:, :, None, None] - bank_b
    dist = torch.cdist(u.reshape(c * l, -1, s), v.reshape(c * l, -1, s),
                       p=1).view(c, l, u.shape[2], v.shape[2])
    excess = 0.5 * (u.sum(-1)[..., :, None] - v.sum(-1)[..., None, :] + dist)
    frac = excess / (caps[:, :, None, None] * s)
    return torch.clamp_min(100.0 * (1.0 - frac.amax(dim=1)), 0.0)


def _score_case(fn, plain, args: Sequence[np.ndarray], scalar=None) -> dict:
    """Kernel vs plain score on one launch's inputs, and the
    ``torch.cdist`` yardstick."""
    dev = _dev(args, [np.float32] * len(args))
    extra = () if scalar is None else (scalar,)
    got = fn(*dev, *extra)
    want = plain(*dev, *extra)
    _sync()
    err = float((got - want).abs().max())
    check(bool(((got >= 0) & (got <= 100)).all()),
          f"{fn.__name__}: a score outside [0, 100]")
    ms = time_ms(lambda: fn(*dev, *extra))
    device = device_us(lambda: fn(*dev, *extra), SCORE_KERNELS)
    plain_ms = time_ms(lambda: plain(*dev, *extra))
    # the library yardstick computes the batched score; the C = 1 (and
    # L = 1) launches take it on a leading axis of one
    if fn is metronome_score_multilink_batch:
        lib_args = dev
    elif fn is metronome_score_multilink:
        lib_args = [t[None] for t in dev]
    else:
        lib_args = [dev[0][None, None], dev[1][None, None],
                    dev[2][None, None],
                    torch.full((1, 1), scalar, device=DEVICE)]
    lib = _score_library(*lib_args).reshape(want.shape)
    library = dict(
        library_ms=time_ms(lambda: _score_library(*lib_args)),
        library="torch.cdist(p=1) over the C*L batches + elementwise",
        library_max_abs_err=float((lib - want).abs().max()))
    base, bank_a, bank_b = args[:3]
    s = base.shape[-1]
    ra, rb = bank_a.shape[-2], bank_b.shape[-2]
    links = int(np.prod(base.shape[:-1]))  # C * L
    # per (c, l, a, b, s): base+A+B-cap, max(., 0), +=; per (c, l, a, b):
    # divide, max over links
    n_ops = ra * rb * links * (4 * s + 2)
    nbytes = 4 * (base.size + bank_a.size + bank_b.size
                  + (1 if scalar is not None else args[3].size) + got.numel())
    bound_ms, bound_by = _bound(nbytes, n_ops)
    return dict(shape={"base": list(base.shape), "bank_a": list(bank_a.shape),
                       "bank_b": list(bank_b.shape)},
                max_abs_err=err, ms=ms, **device,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes, operations=n_ops, **library)


def _score_nan_case() -> dict:
    """A zero-capacity link with zero demand for the even rotations: the
    plain version's excess fraction is 0 / 0 = NaN at (even a, even b);
    every wrapper must give NaN at exactly those places."""
    base, bank_a, bank_b, caps = _score_problem(12, 8, 4, 72, 72, 72)
    base[:, 1] = 0.0
    bank_a[:, 1, 0::2] = 0.0
    bank_b[:, 1, 0::2] = 0.0
    caps[:, 1] = 0.0
    d = _dev((base, bank_a, bank_b, caps), [np.float32] * 4)
    out = {}
    for fn, plain, args in (
            (metronome_score_multilink_batch,
             ref.metronome_score_multilink_batch_ref, d),
            (metronome_score_multilink, ref.metronome_score_multilink_ref,
             [x[0] for x in d]),
            (metronome_score_pairwise, ref.metronome_score_ref,
             (d[0][0, 1], d[1][0, 1], d[2][0, 1], 0.0))):
        got = fn(*args)
        want = plain(*args)
        _sync()
        nan = want.isnan()
        check(bool(nan.any()), f"{fn.__name__}: the plain version gave no NaN")
        check(torch.equal(got.isnan(), nan),
              f"{fn.__name__}: NaN at {int(got.isnan().sum())} places, the "
              f"plain version at {int(nan.sum())}")
        err = float((got - want).abs()[~nan].max())
        check(err <= SCORE_TOL, f"{fn.__name__} (NaN case): max abs err "
                                f"{err} off the NaN places")
        out[fn.__name__] = dict(nan=int(nan.sum()), of=got.numel(),
                                max_abs_err=err)
    return out


def _bound(nbytes: int, n_ops: int,
           peak_ops: float = PEAK_FP32_OPS_PER_S) -> Tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _unmasked_pairs(s: int, causal: bool, window: int) -> int:
    """(q, k) pairs per head that the masks leave, for S = s."""
    i = np.arange(s, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros_like(i)
    hi = i + 1 if causal else np.full_like(i, s)
    return int(np.sum(hi - lo))


def _sdpa(q, k, v, causal: bool, window: int) -> torch.Tensor:
    """The library's attention on the same inputs (timed here only; the
    port never calls it)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window <= 0:
        return sdpa(q, k, v, is_causal=causal, enable_gqa=True)
    s = q.shape[2]
    i = torch.arange(s, device=q.device)
    mask = (i[:, None] - i[None, :]) < window
    if causal:
        mask &= i[:, None] >= i[None, :]
    return sdpa(q, k, v, attn_mask=mask, enable_gqa=True)


def _flash_case(q, k, v, causal: bool, window: int,
                main_path: bool = False, lse: bool = False) -> dict:
    """Flash kernel vs plain attention on one launch's inputs; a main
    path's launch also gets its device-only time.  With ``lse`` (a
    training launch) the forward that also writes each row's logsumexp is
    held to the plain one's lse and to the serving launch's output bit for
    bit, and timed beside it."""
    got = flash_attention_fwd(q, k, v, causal=causal, window=window)
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    _sync()
    lse_info = {}
    if lse:
        got_l, lse_got = flash_attention_fwd(q, k, v, causal=causal,
                                             window=window, return_lse=True)
        _, lse_want = ref.attention_ref(q, k, v, causal=causal,
                                        window=window, return_lse=True)
        lse_diff = (lse_got - lse_want).abs()
        lse_info["lse_max_abs_err"] = float(lse_diff.max())
        check(bool((lse_diff <= LSE_TOL + LSE_TOL * lse_want.abs()).all()),
              f"flash lse {tuple(q.shape)}: max abs err "
              f"{lse_info['lse_max_abs_err']} over {LSE_TOL} abs+rel")
        check(torch.equal(got_l, got), f"flash {tuple(q.shape)}: the lse "
              "launch's output differs from the serving launch's")
        del lse_diff, lse_want
        lse_info["lse_ms"] = time_ms(lambda: flash_attention_fwd(
            q, k, v, causal=causal, window=window, return_lse=True))
        if main_path:
            lse_info["lse_device_us_per_launch"] = device_us(
                lambda: flash_attention_fwd(q, k, v, causal=causal,
                                            window=window, return_lse=True),
                FLASH_KERNELS)["device_us_per_launch"]
    tol = FLASH_TOL[q.dtype]
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    rel_l2 = float(torch.linalg.vector_norm(diff)) / max(
        float(torch.linalg.vector_norm(want.float())), 1e-30)
    what = (f"flash kernel {tuple(q.shape)} {q.dtype} causal={causal} "
            f"window={window}: max abs err {err}, normwise err {rel_l2}")
    check(bool(torch.isfinite(got).all()), "flash kernel: non-finite")
    check(bool((diff <= tol + tol * want.float().abs()).all()),
          f"{what}; elementwise over {tol} abs+rel")
    if q.dtype == torch.bfloat16:
        check(rel_l2 <= FLASH_NORM_TOL,
              f"{what}; normwise over {FLASH_NORM_TOL}")
    lib = _sdpa(q, k, v, causal, window)
    lib_err = float((lib.float() - want.float()).abs().max())
    ms = time_ms(lambda: flash_attention_fwd(q, k, v, causal=causal,
                                             window=window))
    plain_ms = time_ms(lambda: ref.attention_ref(q, k, v, causal=causal,
                                                 window=window),
                       reps=5, warmup=1)
    library_ms = time_ms(lambda: _sdpa(q, k, v, causal, window))
    device = {}
    if main_path:
        device = device_us(lambda: flash_attention_fwd(
            q, k, v, causal=causal, window=window), FLASH_KERNELS)
        lib_dev = device_us(lambda: _sdpa(q, k, v, causal, window), None)
        device.update(library_device_us=lib_dev["device_us_per_launch"],
                      library_device_traced=lib_dev["device_traced"],
                      library_device_attempts=lib_dev["device_attempts"],
                      library_device_kernels=lib_dev["device_kernels"])
    b, h, s, d = q.shape
    pairs = _unmasked_pairs(s, causal, window)
    n_ops = b * h * pairs * 4 * d  # q.k and p.v, a multiply and an add each
    nbytes = (q.numel() + k.numel() + v.numel() + got.numel()) \
        * q.element_size()
    peak = PEAK_BF16_OPS_PER_S if q.dtype == torch.bfloat16 \
        else PEAK_FP32_OPS_PER_S
    bound_ms, bound_by = _bound(nbytes, n_ops, peak)
    return dict(shape={"q": list(q.shape), "kv": list(k.shape)},
                dtype=str(q.dtype), causal=causal, window=window,
                max_abs_err=err, tolerance=tol, normwise_err=rel_l2,
                ms=ms, **device, **lse_info, plain_ms=plain_ms,
                library_ms=library_ms, library_max_abs_err=lib_err,
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                operations=n_ops, unmasked_pairs_per_head=pairs)


def _sdpa_backward(q, k, v, do, causal: bool, window: int):
    """The library's backward alone on the same inputs: a function that
    takes the gradient of one ``scaled_dot_product_attention`` forward,
    kept (timed here only; the port never calls it)."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = _sdpa(*leaves, causal, window)
    return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)


def flash_bwd_kernels(q: torch.Tensor, k: torch.Tensor) -> int:
    """Distinct kernels one backward launch on these inputs runs (see
    :data:`FLASH_BWD_KERNELS`)."""
    b, h, s, d = q.shape
    split = _bwd_head_split(
        b, h, k.shape[1], s, d, q.dtype == torch.bfloat16,
        torch.cuda.get_device_properties(q.device).multi_processor_count)
    return 3 + (split > 1)


def _flash_bwd_case(q, k, v, o, lse, do, causal: bool, window: int,
                    main_path: bool = False) -> dict:
    """The attention backward kernel on one launch's inputs (the forward's
    o and lse): held to its plain twin and to autograd through
    ``attention_ref`` (the recompute it replaced) at the flash bars, two
    calls bit for bit, the forward's lse to the plain one's.  A main
    path's launch also gets the device time a launch of the kernel (its
    kernels), of that recompute (which it must beat) and of the library's
    backward, which the bf16 kernel must not exceed by more than
    :data:`FLASH_BWD_FLOOR`."""
    causal, window = bool(causal), int(window)  # recorded as numpy
    # as ops.flash_attention_bwd hands them on (the layers' upstream
    # gradient is a transposed view)
    q, k, v, o, lse, do = (t.contiguous() for t in (q, k, v, o, lse, do))
    args = (q, k, v, o, lse, do, causal, window)
    got = _flash_attention_bwd(*args)
    again = _flash_attention_bwd(*args)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window)
    _sync()
    what = (f"flash backward {tuple(q.shape)} / {tuple(k.shape)} {q.dtype} "
            f"causal={causal} window={window}")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{what}: two calls on the same inputs differ")
    del again
    tol = FLASH_BWD_TOL[q.dtype]

    def compare(ref_grads, gate_normwise: bool) -> dict:
        """Elementwise at the bar, bf16 normwise where ``gate_normwise``.
        At window 1 a row sees its own key alone, dS = P (dP - delta) = 0
        and dQ and dK are rounding noise: held to 1e-3 absolute there."""
        errs = {}
        for name, a, b in zip(("dq", "dk", "dv"), got, ref_grads):
            a, b = a.float(), b.float()
            check(bool(torch.isfinite(a).all()), f"{what}: {name} not finite")
            diff = (a - b).abs()
            norm = float(torch.linalg.vector_norm(b))
            errs[name] = dict(max_abs_err=float(diff.max()), normwise_err=(
                float(torch.linalg.vector_norm(diff)) / norm if norm > 0.0
                else None))
            check(bool((diff <= tol + tol * b.abs()).all()),
                  f"{what}: {name} {errs[name]}, elementwise over {tol} "
                  "abs+rel")
            if window == 1 and name != "dv":
                check(float(a.abs().max()) <= 1e-3,
                      f"{what}: {name} is not 0 where every row sees one key")
            elif gate_normwise and q.dtype == torch.bfloat16:
                check(errs[name]["normwise_err"] <= FLASH_NORM_TOL,
                      f"{what}: {name} normwise over {FLASH_NORM_TOL}")
        return errs

    errs = compare(want, True)
    del want

    def recompute():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = ref.attention_ref(*leaves, causal=causal, window=window)
        return torch.autograd.grad(out, leaves, do)

    errs_replaced = compare(recompute(), False)
    _, lse_want = ref.attention_ref(q, k, v, causal=causal, window=window,
                                    return_lse=True)
    lse_diff = (lse - lse_want).abs()
    lse_err = float(lse_diff.max())
    check(bool((lse_diff <= LSE_TOL + LSE_TOL * lse_want.abs()).all()),
          f"{what}: the forward's lse {lse_err} from the plain one's")
    del lse_diff, lse_want
    ms = time_ms(lambda: _flash_attention_bwd(*args))
    plain_ms = time_ms(lambda: ref.flash_attention_bwd_ref(
        q, k, v, o, lse, do, causal=causal, window=window), reps=3, warmup=1)
    recompute_ms = time_ms(recompute, reps=3, warmup=1)
    device, library_ms = {}, None
    if main_path:
        device = device_us(lambda: _flash_attention_bwd(*args),
                           FLASH_BWD_KERNELS,
                           per_launch=flash_bwd_kernels(q, k))
        device["recompute_device_us"] = device_us(
            recompute, None, reps=5, per_call=True)["device_us_per_launch"]
        check(device["device_us_per_launch"] < device["recompute_device_us"],
              f"{what}: {device['device_us_per_launch']} device us a launch, "
              f"not below the recompute's {device['recompute_device_us']}")
        try:  # a yardstick only: a backend that refuses these inputs
            lib = _sdpa_backward(q, k, v, do, causal, window)
            library_ms = time_ms(lib)
            # a burst as long as the kernel's: a trace that lost over half
            # of 50 calls took a twice-a-call event's count for the calls
            lib_dev = device_us(lib, None, reps=200, per_call=True)
            device.update(library_device_us=lib_dev["device_us_per_launch"],
                          library_device_traced=lib_dev["device_traced"],
                          library_device_kernels=lib_dev["device_kernels"])
            del lib
        except RuntimeError as e:  # reads as no library time
            device.update(library_device_us=None,
                          library_error=str(e)[:300])
        if q.dtype == torch.bfloat16:
            # under 1.5x at D <= 128, at most 1.0x at D = 256
            floor = FLASH_BWD_FLOOR[q.shape[-1]]
            lib_us, us = device["library_device_us"], \
                device["device_us_per_launch"]
            check(lib_us is not None and (us < floor * lib_us if floor > 1.0
                                          else us <= floor * lib_us),
                  f"{what}: {us} device us a launch against the library "
                  f"backward's {lib_us} (at most {floor}x)")
    b, h, s, d = q.shape
    pairs = _unmasked_pairs(s, causal, window)
    n_ops = b * h * pairs * 10 * d  # S, dP, dV, dQ, dK: 2 D each
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() \
        + lse.numel() * 4  # q, o, dO, k, v, lse read; dq, dk, dv written
    peak = PEAK_BF16_OPS_PER_S if q.dtype == torch.bfloat16 \
        else PEAK_FP32_OPS_PER_S
    bound_ms, bound_by = _bound(nbytes, n_ops, peak)
    return dict(shape={"q": list(q.shape), "kv": list(k.shape)},
                dtype=str(q.dtype), causal=causal, window=window,
                max_abs_err=max(e["max_abs_err"] for e in errs.values()),
                errors=errs, tolerance=tol, bit_equal_calls=True,
                vs_replaced_recompute=errs_replaced, lse_max_abs_err=lse_err,
                ms=ms, **device, plain_ms=plain_ms,
                recompute_ms=recompute_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                operations=n_ops, unmasked_pairs_per_head=pairs)


def _rg_lru_case(a, x, main_path: bool = False) -> dict:
    """RG-LRU kernel vs the plain loop on one launch's inputs; a main
    path's launch also gets its device-only time."""
    got = rg_lru_pallas(a, x)
    want = ref.rg_lru_ref(a, x)
    _sync()
    diff = (got - want).abs()
    err = float(diff.max())
    check(bool((diff <= RG_LRU_TOL + RG_LRU_TOL * want.abs()).all()),
          f"RG-LRU kernel {tuple(x.shape)}: max abs err {err}")
    ms = time_ms(lambda: rg_lru_pallas(a, x))
    device = {}
    if main_path:
        device = device_us(lambda: rg_lru_pallas(a, x), ("rg_lru_kernel",))
    plain_ms = time_ms(lambda: ref.rg_lru_ref(a, x), reps=3, warmup=1)
    nbytes = 3 * x.numel() * 4
    bound_ms, bound_by = _bound(nbytes, 2 * x.numel())
    return dict(shape=list(x.shape), max_abs_err=err,
                bit_exact=bool(torch.equal(got, want)), ms=ms, **device,
                plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                bound_by=bound_by, bytes=nbytes, operations=2 * x.numel())


def _rg_lru_bwd_case(a, y, g) -> dict:
    """RG-LRU backward kernel vs the plain reverse loop on one launch's
    inputs; it must match bit for bit."""
    da, dx = _rg_lru_pallas_bwd(a, y, g)
    da_want, dx_want = ref.rg_lru_bwd_ref(a, y, g)
    _sync()
    err = max(float((da - da_want).abs().max()),
              float((dx - dx_want).abs().max()))
    check(torch.equal(da, da_want) and torch.equal(dx, dx_want),
          f"RG-LRU backward kernel {tuple(g.shape)}: not bit for bit with "
          f"the plain reverse loop, max abs err {err}")
    ms = time_ms(lambda: _rg_lru_pallas_bwd(a, y, g))
    device = device_us(lambda: _rg_lru_pallas_bwd(a, y, g),
                       ("rg_lru_bwd_kernel",))
    plain_ms = time_ms(lambda: ref.rg_lru_bwd_ref(a, y, g), reps=3,
                       warmup=1)
    nbytes = 5 * g.numel() * 4  # g, a, y read; dx, da written
    n_ops = 3 * g.numel()  # a multiply and an add for d, a multiply for da
    bound_ms, bound_by = _bound(nbytes, n_ops)
    return dict(shape=list(g.shape), max_abs_err=err, bit_exact=True, ms=ms,
                **device, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                operations=n_ops)


def _qkv(seed: int, b: int, h: int, hkv: int, s: int, d: int, dtype):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=DEVICE).to(dtype)
            for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d))]


def _gates(seed: int, shape: Tuple[int, ...]):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    a = torch.sigmoid(torch.randn(shape, generator=g, device=DEVICE)) \
        * 0.3 + 0.65
    return a, torch.randn(shape, generator=g, device=DEVICE)


def _flash_inputs(rec: Recorder, causal: bool,
                  name: str = "flash_attention") -> list:
    """The first recorded flash launch (or backward launch) with this
    causal flag."""
    at = 3 if name == "flash_attention" else 6
    return next(a for a in rec.inputs(name) if bool(a[at]) == causal)


# the attention backward on its own: (B, H, Hkv, S, D), dtype, causal,
# window; every mask, head dim and group size, ragged S
FLASH_BWD_SYNTHETIC = {
    "flash_bwd_f32_d64_g1": ((2, 4, 4, 256, 64), torch.float32, True, 0),
    "flash_bwd_f32_d128_g4": ((2, 4, 1, 256, 128), torch.float32, True, 0),
    "flash_bwd_f32_d256_g10_window63": ((1, 10, 1, 300, 256), torch.float32,
                                        True, 63),
    "flash_bwd_f32_bidirectional_window50": ((1, 2, 2, 200, 64),
                                             torch.float32, False, 50),
    "flash_bwd_bf16_d64_window1": ((1, 2, 1, 300, 64), torch.bfloat16, True,
                                   1),
    "flash_bwd_bf16_d256_window63": ((1, 2, 1, 300, 256), torch.bfloat16,
                                     True, 63),
    "flash_bwd_bf16_d256_g10_window2048_s3000": (
        (1, 10, 1, 3000, 256), torch.bfloat16, True, 2048),
    "flash_bwd_bf16_d128_bidirectional": ((1, 4, 2, 300, 128),
                                          torch.bfloat16, False, 0),
    "flash_bwd_bf16_d256_bidirectional_window100": (
        (1, 4, 2, 333, 256), torch.bfloat16, False, 100),
    "flash_bwd_bf16_s37_d256_g4": ((1, 4, 1, 37, 256), torch.bfloat16, True,
                                   0),
    "flash_bwd_bf16_s130_d128_g4": ((1, 8, 2, 130, 128), torch.bfloat16,
                                    True, 0),
    "flash_bwd_bf16_s1001_d64_g4": ((2, 4, 1, 1001, 64), torch.bfloat16,
                                    True, 0),
}


def _flash_bwd_synthetic(seed: int, shape, dtype, causal: bool,
                         window: int) -> dict:
    b, h, hkv, s, d = shape
    q, k, v = _qkv(seed, b, h, hkv, s, d, dtype)
    o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                 return_lse=True)
    do = torch.randn(o.shape, generator=torch.Generator(
        device=DEVICE).manual_seed(seed + 1), device=DEVICE).to(dtype)
    return _flash_bwd_case(q, k, v, o, lse, do, causal, window)


def model_kernel_cases(recs: Dict[str, Recorder]) -> Dict[str, dict]:
    """The flash and RG-LRU kernels on the serve and train paths' first
    launches, then on synthetic cases."""
    cases: Dict[str, dict] = {}
    serve, train = recs["serve"], recs["train"]
    # Llama-3-8B: head dim 128, 32 q heads over 8 kv heads, causal;
    # Qwen1.5-MoE: head dim 128, one q head a kv head, causal; Whisper:
    # head dim 64, 12 heads, the encoder bidirectional over the frames, the
    # decoder causal over the prompt
    for name, rec, causal in (
            ("flash_serve_dense", recs["serve_dense"], True),
            ("flash_train_dense", recs["train_dense"], True),
            ("flash_serve_sharded", recs["serve_sharded"], True),
            ("flash_train_sharded", recs["train_sharded"], True),
            ("flash_serve_moe", recs["serve_moe"], True),
            ("flash_train_moe", recs["train_moe"], True),
            ("flash_serve_encdec_encoder", recs["serve_encdec"], False),
            ("flash_serve_encdec_decoder", recs["serve_encdec"], True),
            ("flash_train_small_encoder", recs["train_small"], False),
            ("flash_train_small_decoder", recs["train_small"], True)):
        q, k, v, causal, window = _flash_inputs(rec, causal)
        cases[name] = _flash_case(q, k, v, bool(causal), int(window),
                                  main_path=True, lse="_train_" in name)
        del q, k, v
    q, k, v, causal, window = serve.inputs("flash_attention")[0]
    cases["flash_serve"] = _flash_case(q, k, v, bool(causal), int(window),
                                      main_path=True)
    a, x = serve.inputs("rg_lru")[0]
    cases["rg_lru_serve"] = _rg_lru_case(a, x, main_path=True)
    q, k, v, causal, window = train.inputs("flash_attention")[0]
    cases["flash_train"] = _flash_case(q, k, v, bool(causal), int(window),
                                      main_path=True, lse=True)
    a, x = train.inputs("rg_lru")[0]
    cases["rg_lru_train"] = _rg_lru_case(a, x, main_path=True)
    a, y, g = train.inputs("rg_lru_bwd")[0]
    cases["rg_lru_bwd_train"] = _rg_lru_bwd_case(a, y, g)
    # the griffin smoke config (head dim 64, a 16-token window) on DTensor
    # blocks, in train_sharded and in the elastic resume
    for tag in ("train_sharded_griffin", "elastic"):
        rec = recs[tag]
        q, k, v, causal, window = rec.inputs("flash_attention")[0]
        cases[f"flash_{tag}"] = _flash_case(q, k, v, bool(causal),
                                            int(window), main_path=True,
                                            lse=True)
        a, x = rec.inputs("rg_lru")[0]
        cases[f"rg_lru_{tag}"] = _rg_lru_case(a, x, main_path=True)
        a, y, g = rec.inputs("rg_lru_bwd")[0]
        cases[f"rg_lru_bwd_{tag}"] = _rg_lru_bwd_case(a, y, g)
    # the attention backward on each training path's first launch: the
    # griffin model (D=256, 10 q heads over 1, window 2048), Llama-3-8B
    # (D=128, 32 over 8), Qwen1.5-MoE (16 over 16), Whisper's encoder
    # (bidirectional) and decoder (D=64), and DTensor blocks
    for name, rec, causal in (
            ("flash_bwd_train", recs["train"], True),
            ("flash_bwd_train_dense", recs["train_dense"], True),
            ("flash_bwd_train_moe", recs["train_moe"], True),
            ("flash_bwd_train_small_encoder", recs["train_small"], False),
            ("flash_bwd_train_small_decoder", recs["train_small"], True),
            ("flash_bwd_train_sharded", recs["train_sharded"], True),
            ("flash_bwd_train_sharded_griffin",
             recs["train_sharded_griffin"], True),
            ("flash_bwd_elastic", recs["elastic"], True)):
        inputs = _flash_inputs(rec, causal, "flash_attention_bwd")
        cases[name] = _flash_bwd_case(*inputs, main_path=True)
        del inputs
    for i, (name, (shape, dtype, causal, window)) in enumerate(
            FLASH_BWD_SYNTHETIC.items()):
        cases[name] = _flash_bwd_synthetic(20 + i, shape, dtype, causal,
                                           window)
    a, x = _gates(12, (2, 1001, 1000))  # S % 64 = 41, W % 32 = 8
    y = ref.rg_lru_ref(a, x)
    cases["rg_lru_bwd_ragged_2x1001x1000"] = _rg_lru_bwd_case(
        a, y, torch.randn_like(y))
    for d in (64, 128):
        for g in (1, 4):
            cases[f"flash_f32_causal_d{d}_g{g}"] = _flash_case(
                *_qkv(d + g, 2, 4, 4 // g, 256, d, torch.float32), True, 0)
    cases["flash_bf16_window256"] = _flash_case(
        *_qkv(5, 1, 4, 1, 1024, 128, torch.bfloat16), True, 256)
    cases["flash_f32_bidirectional"] = _flash_case(
        *_qkv(6, 1, 2, 2, 256, 64, torch.float32), False, 0)
    cases["flash_bf16_ragged_s1000_d256_g10"] = _flash_case(
        *_qkv(7, 1, 10, 1, 1000, 256, torch.bfloat16), True, 0)
    # the bf16 tensor-core kernel's edges: head dims 64 and 128, S shorter
    # than and just past one 128-row q tile, windows inside one tile, one
    # kv head per q head, bidirectional with a window
    for name, shape, causal, window in (
            ("flash_bf16_d64", (2, 4, 1, 256, 64), True, 0),
            ("flash_bf16_d128", (2, 4, 1, 256, 128), True, 0),
            ("flash_bf16_s37_d256", (1, 4, 1, 37, 256), True, 0),
            ("flash_bf16_s130_d128", (1, 4, 1, 130, 128), True, 0),
            ("flash_bf16_window1", (1, 2, 1, 300, 64), True, 1),
            ("flash_bf16_window63_d256", (1, 2, 1, 300, 256), True, 63),
            ("flash_bf16_mha_d256", (1, 4, 4, 512, 256), True, 0),
            ("flash_bf16_bidirectional_window100", (1, 4, 2, 333, 256),
             False, 100)):
        cases[name] = _flash_case(
            *_qkv(sum(shape) + window, *shape, torch.bfloat16), causal,
            window)
    cases["rg_lru_2x512x1024"] = _rg_lru_case(*_gates(8, (2, 512, 1024)))
    cases["rg_lru_ragged_1x37x300"] = _rg_lru_case(*_gates(9, (1, 37, 300)))
    cases["rg_lru_3x4064x2560"] = _rg_lru_case(*_gates(10, (3, 4064, 2560)))
    cases["rg_lru_ragged_2x65x33"] = _rg_lru_case(*_gates(11, (2, 65, 33)))
    flash = cases["flash_serve"]
    check(flash["ms"] < flash["library_ms"],
          f"flash kernel {flash['ms']} ms at the serving shape is not below "
          f"scaled_dot_product_attention's {flash['library_ms']} ms")
    for name in FLASH_FLOOR_CASES:
        case = cases[name]
        check(case["device_us_per_launch"]
              <= FLASH_FLOOR * case["library_device_us"],
              f"{name}: flash kernel {case['device_us_per_launch']} device "
              f"us a launch is over {FLASH_FLOOR}x scaled_dot_product_"
              f"attention's {case['library_device_us']} device us a call")
    return cases


def _score_problem(seed: int, c: int, l: int, ra: int, rb: int, s: int):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.0, 8.0, (c, l, s))
    bank_a = rng.uniform(0.0, 12.0, (c, l, ra, s))
    bank_b = rng.uniform(0.0, 12.0, (c, l, rb, s))
    caps = rng.uniform(18.0, 30.0, (c, l))
    return base, bank_a, bank_b, caps


def phase_kernels(corpus: Recorder, loop: Recorder, grid: Recorder,
                  figures: Recorder, robust: Recorder, planner: Recorder,
                  recs: Dict[str, Recorder]) -> dict:
    cases: Dict[str, dict] = {}
    # the main path's fill launches all take the one-word route masks
    links = {rec_name: sorted({shape[1][2] for shape in rec.counts[
        "progressive_fill"]}) for rec_name, rec in (
            ("corpus", corpus), ("loop", loop), ("paper_grid", grid),
            ("paper_figures", figures), ("robustness", robust))}
    check(all(l <= 32 for ls in links.values() for l in ls),
          f"a main-path fill launch has more than 32 links: {links}")
    cases["fill_links_on_main_path"] = dict(links=links)
    # fill: the trace corpus's buckets, the event loop's commonest launch
    cases["fill_trace_corpus"] = _fill_case(corpus.inputs("progressive_fill"))
    _, n, args = loop.most_common("progressive_fill")
    cases["fill_event_loop"] = dict(_fill_case([args]),
                                    calls_of_this_shape=n)
    for name, rec in (("fill_paper_grid", grid),
                      ("fill_paper_figures", figures),
                      ("fill_robustness", robust)):
        _, n, args = rec.most_common("progressive_fill")
        cases[name] = dict(_fill_case([args]), calls_of_this_shape=n)
    # padded neutrality: zero-demand flows, zero-route unit-capacity links
    d = np.array([[0.0, 10.0, 0.0, 4.0] + [0.0] * 4])
    r = np.zeros((1, 8, 128))
    r[0, :4, 0] = 1.0
    c = np.ones((1, 128))
    c[0, 0] = 8.0
    got = metronome_fill(*_dev((d, r, c), FILL_TYPES)).cpu().numpy()
    check(got[0, 0] == 0.0 and got[0, 2] == 0.0 and np.all(got[0, 4:] == 0),
          "fill kernel: a padded flow got a rate")
    check(abs(got[0, 1] - 4.0) <= FILL_TOL and abs(got[0, 3] - 4.0)
          <= FILL_TOL, f"fill kernel: padded case rates {got[0, :4]}")
    cases["fill_padding"] = dict(rates=[float(x) for x in got[0, :4]])
    for name in ("fill_trace_corpus", "fill_event_loop", "fill_paper_grid",
                 "fill_paper_figures", "fill_robustness"):
        check(cases[name]["max_abs_err"] == 0.0,
              f"{name}: kernel vs plain {cases[name]['max_abs_err']}")

    # score: the planner's own launches, then the wide candidate batch
    for name, fn, plain in (
            ("score_multilink", metronome_score_multilink,
             ref.metronome_score_multilink_ref),
            ("score_multilink_batch", metronome_score_multilink_batch,
             ref.metronome_score_multilink_batch_ref)):
        for i, args in enumerate(planner.inputs(name)):
            cases[f"{name}_planner{i}"] = _score_case(fn, plain, args)
        for i, args in enumerate(figures.inputs(name)):
            cases[f"{name}_paper_figures{i}"] = _score_case(fn, plain, args)
    cases["score_multilink_batch_C64"] = _score_case(
        metronome_score_multilink_batch,
        ref.metronome_score_multilink_batch_ref,
        _score_problem(3, 64, 4, 72, 72, 72))
    base, bank_a, bank_b, caps = _score_problem(4, 1, 1, 36, 72, 72)
    cases["score_pairwise_36x72"] = _score_case(
        metronome_score_pairwise, ref.metronome_score_ref,
        (base[0, 0], bank_a[0, 0], bank_b[0, 0]), scalar=float(caps[0, 0]))
    # padding links (zero demand, unit capacity) score exactly 100
    base, bank_a, bank_b, caps = _score_problem(5, 2, 3, 24, 36, 72)
    zero = np.zeros_like
    pad = metronome_score_multilink_batch(*_dev(
        (zero(base), zero(bank_a), zero(bank_b), np.ones_like(caps)),
        [np.float32] * 4)).cpu()
    check(bool((pad == 100.0).all()), "padding links did not score 100")
    cases["score_nan_zero_capacity"] = _score_nan_case()
    for name, case in cases.items():
        if name.startswith("score_") and "max_abs_err" in case:
            check(case["max_abs_err"] <= SCORE_TOL,
                  f"{name}: kernel vs plain {case['max_abs_err']}")
    cases.update(model_kernel_cases(recs))
    emit("kernels", tolerance={
        "fill": 0.0, "score": SCORE_TOL, "rg_lru": RG_LRU_TOL,
        "rg_lru_bwd": 0.0,
        "flash": {str(k): v for k, v in FLASH_TOL.items()},
        "flash_bf16_normwise": FLASH_NORM_TOL,
        "flash_bwd": {str(k): v for k, v in FLASH_BWD_TOL.items()},
        "flash_bwd_bf16_normwise": FLASH_NORM_TOL, "lse": LSE_TOL},
        cases=cases)
    return cases


def _redesign(name: str, ptxas: Dict[str, Dict[str, dict]]) -> dict:
    """A redesigned kernel's design and its ptxas registers and spills by
    entry (None where this run found its library built)."""
    info = REDESIGNED[name]
    entries = {want: v for want in info["ptxas_entries"]
               for src in ptxas.values() for k, v in src.items() if want in k}
    return dict(design=info["design"], ptxas=entries or None)


def _flash_ratios(case: dict) -> dict:
    """A flash case's device time over the library call's (what the floor
    holds), the same over CUDA-event ms around each call (the wrapper's
    host work included; for information), and its bound's share of the
    kernel's device time."""
    return dict(device_vs_library=case["device_us_per_launch"]
                / case["library_device_us"],
                vs_library=case["ms"] / case["library_ms"],
                bound_share=case["bound_ms"] * 1e3
                / case["device_us_per_launch"])


def kernel_summary(launches: Dict[str, int], cases: Dict[str, dict],
                   ptxas: Dict[str, Dict[str, dict]]) -> dict:
    fill = cases["fill_trace_corpus"]
    score = cases["score_multilink_batch_planner0"]
    flash = cases["flash_serve"]
    rg = cases["rg_lru_serve"]
    rg_bwd = cases["rg_lru_bwd_train"]
    fbwd = cases["flash_bwd_train_dense"]
    score_err = max(v["max_abs_err"] for n, v in cases.items()
                    if n.startswith("score_") and "max_abs_err" in v)
    fill_err = max(v["max_abs_err"] for n, v in cases.items()
                   if n.startswith("fill_") and "max_abs_err" in v)
    device_us = {n: v["device_us_per_launch"] for n, v in cases.items()
                 if "device_us_per_launch" in v}
    kernels = [
        dict(name="metronome_fill", route="cuda",
             source="src/repro_torch/kernels/csrc/metronome_fill.cu",
             replaces="src/repro/kernels/metronome_fill.py:39",
             launches=launches.get("metronome_fill", 0),
             max_abs_err=fill_err, ms=fill["ms"], plain_ms=fill["plain_ms"],
             bound_ms=fill["bound_ms"], bound_by=fill["bound_by"],
             library_ms=None,
             library="none: no single PyTorch call computes a "
                     "progressive fill",
             device_us_per_launch={n: v for n, v in device_us.items()
                                   if n.startswith("fill_")},
             **_redesign("metronome_fill", ptxas)),
        dict(name="metronome_score", route="cuda",
             source="src/repro_torch/kernels/csrc/metronome_score.cu",
             replaces="src/repro/kernels/metronome_score.py:115",
             also_replaces=["src/repro/kernels/metronome_score.py:95",
                            "src/repro/kernels/metronome_score.py:39"],
             launches=sum(launches.get(w.__name__, 0)
                          for w in SCORE_WRAPPERS),
             wrapper_launches={w.__name__: launches.get(w.__name__, 0)
                               for w in SCORE_WRAPPERS},
             max_abs_err=score_err, ms=score["ms"],
             plain_ms=score["plain_ms"], bound_ms=score["bound_ms"],
             bound_by=score["bound_by"], library_ms=score["library_ms"],
             library=score["library"],
             library_max_abs_err=score["library_max_abs_err"],
             nan_case=cases["score_nan_zero_capacity"],
             device_us_per_launch={n: v for n, v in device_us.items()
                                   if n.startswith("score_")},
             **_redesign("metronome_score", ptxas)),
        dict(name="flash_attention_fwd", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:31",
             launches=launches.get("flash_attention_fwd", 0),
             max_abs_err=flash["max_abs_err"],
             normwise_err=flash["normwise_err"], ms=flash["ms"],
             plain_ms=flash["plain_ms"], bound_ms=flash["bound_ms"],
             bound_by=flash["bound_by"], library_ms=flash["library_ms"],
             library="torch.nn.functional.scaled_dot_product_attention",
             shape=flash["shape"],
             main_path_cases={n: dict(
                 {k: cases[n][k] for k in (
                     "shape", "window", "ms", "device_us_per_launch",
                     "device_traced", "device_attempts", "plain_ms",
                     "bound_ms", "bound_by", "library_ms",
                     "library_device_us", "library_device_attempts",
                     "max_abs_err", "normwise_err")},
                 **_flash_ratios(cases[n])) for n in MAIN_PATH_FLASH},
             device_us_per_launch={n: v for n, v in device_us.items()
                                   if n.startswith("flash_")
                                   and not n.startswith("flash_bwd_")},
             # the training launches' device us: serving entry, lse entry
             lse_device_us_per_launch={
                 n: [cases[n]["device_us_per_launch"],
                     cases[n]["lse_device_us_per_launch"]]
                 for n in MAIN_PATH_FLASH
                 if "lse_device_us_per_launch" in cases[n]},
             **_redesign("flash_attention_fwd", ptxas)),
        dict(name="rg_lru_pallas", route="cuda",
             source="src/repro_torch/kernels/csrc/rg_lru.cu",
             replaces="src/repro/kernels/rg_lru.py:25",
             launches=launches.get("rg_lru_pallas", 0),
             max_abs_err=rg["max_abs_err"], ms=rg["ms"],
             plain_ms=rg["plain_ms"], bound_ms=rg["bound_ms"],
             bound_by=rg["bound_by"], library_ms=None,
             library="none: no single PyTorch call computes a first-order "
                     "linear recurrence",
             shape=rg["shape"], bit_exact=rg["bit_exact"],
             device_us_per_launch={n: v for n, v in device_us.items()
                                   if n.startswith("rg_lru_")
                                   and "_bwd_" not in n},
             **_redesign("rg_lru_pallas", ptxas)),
        dict(name="_rg_lru_pallas_bwd", route="cuda",
             source="src/repro_torch/kernels/csrc/rg_lru.cu",
             replaces="src/repro/kernels/rg_lru.py:25",
             note="the adjoint of that kernel's recurrence; the TPU "
                  "reference has no backward kernel (XLA differentiates "
                  "its associative_scan, src/repro/models/recurrent.py:85)",
             launches=launches.get("_rg_lru_pallas_bwd", 0),
             max_abs_err=rg_bwd["max_abs_err"], ms=rg_bwd["ms"],
             plain_ms=rg_bwd["plain_ms"], bound_ms=rg_bwd["bound_ms"],
             bound_by=rg_bwd["bound_by"], library_ms=None,
             library="none: no single PyTorch call computes the adjoint of "
                     "a linear recurrence",
             shape=rg_bwd["shape"], bit_exact=rg_bwd["bit_exact"],
             device_us_per_launch={n: v for n, v in device_us.items()
                                   if n.startswith("rg_lru_bwd_")},
             **_redesign("_rg_lru_pallas_bwd", ptxas)),
        dict(name="_flash_attention_bwd", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
             replaces="src/repro/kernels/ops.py:51",
             note="port-only: the TPU reference has no backward kernel; "
                  "its _fa_bwd (src/repro/kernels/ops.py:51) recomputes "
                  "the forward through attention_ref and differentiates "
                  "it, which the port did on the card until this kernel",
             launches=launches.get("_flash_attention_bwd", 0),
             max_abs_err=max(v["max_abs_err"] for n, v in cases.items()
                             if n.startswith("flash_bwd_")),
             ms=fbwd["ms"], plain_ms=fbwd["plain_ms"],
             bound_ms=fbwd["bound_ms"], bound_by=fbwd["bound_by"],
             library_ms=fbwd["library_ms"],
             library="the backward alone of torch.nn.functional."
                     "scaled_dot_product_attention",
             shape=fbwd["shape"],
             main_path_cases={n: dict(
                 {k: cases[n][k] for k in (
                     "shape", "window", "ms", "device_us_per_launch",
                     "recompute_device_us", "plain_ms", "bound_ms",
                     "library_ms", "library_device_us")},
                 normwise_err=max(e["normwise_err"] or 0.0
                                  for e in cases[n]["errors"].values()),
                 vs_recompute=cases[n]["device_us_per_launch"]
                 / cases[n]["recompute_device_us"],
                 vs_library=cases[n]["device_us_per_launch"]
                 / cases[n]["library_device_us"]
                 if cases[n].get("library_device_us") else None,
                 bound_share=cases[n]["bound_ms"] * 1e3
                 / cases[n]["device_us_per_launch"])
                 for n in MAIN_PATH_FLASH_BWD},
             **_redesign("_flash_attention_bwd", ptxas)),
    ]
    return {"kernels": kernels}


def _digits(x, n: int = 6):
    """``x`` with every float given to ``n`` significant digits, for the
    summary line (the kernels phase's line above it keeps every digit)."""
    if isinstance(x, float):
        return float(f"{x:.{n}g}")
    if isinstance(x, dict):
        return {k: _digits(v, n) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_digits(v, n) for v in x]
    return x


# the D=128 and D=64 main-path launches: (B, H, Hkv, S, D, causal)
FLASH_COMPARE_SHAPES = {
    "serve_dense": (4, 32, 8, 4064, 128, True),
    "train_dense": (1, 32, 8, 4096, 128, True),
    "serve_sharded": (4, 32, 8, 4088, 128, True),
    "serve_moe": (4, 16, 16, 4064, 128, True),
    "train_moe": (1, 16, 16, 4096, 128, True),
    "serve_encdec_encoder": (4, 12, 12, 1016, 64, False),
    "serve_encdec_decoder": (4, 12, 12, 4064, 64, True),
    "train_small_encoder": (1, 12, 12, 1024, 64, False),
    "train_small_decoder": (1, 12, 12, 4096, 64, True),
}


def _build_other(name: str, source: str) -> Tuple[Path, str]:
    """Build another version of ``kernels/csrc/<name>.cu`` with this
    checkout's flags into ``build/compare/``; its path and ptxas log."""
    out_dir = ROOT / "build" / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    other_so = out_dir / f"{name}_other.so"
    proc = subprocess.run(
        [_cuda_build.nvcc(), *_cuda_build._flags(name), "-Xptxas", "-v",
         "-o", str(other_so), source],
        capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"nvcc {source}: {proc.stdout}"
          f"{proc.stderr}")
    return other_so, proc.stdout + proc.stderr


def compare_flash(other_source: str) -> dict:
    """Another ``flash_attention.cu`` (a parent commit's) against this
    checkout's, on one card: the other built with the same flags under
    another name, each called at every D=128 and D=64 main-path shape on
    one seed's inputs, their device time a launch taken in the order
    other, this, this, other, with the library's call's before and after;
    each output's normwise error against ``attention_ref``."""
    from repro_torch.kernels import flash_attention as fa
    other_so, _ = _build_other("flash_attention", other_source)
    # an older build may have no lse entry: bind its serving entry alone
    libs = {"other": fa._bind_serving(ctypes.CDLL(str(other_so))),
            "this": _cuda_build.load("flash_attention", fa._bind)}

    def call(lib, q, k, v, causal):
        b, h, s, d = q.shape
        out = torch.empty_like(q)
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            k.shape[1], s, d, 1, int(causal), 0, 1.0 / math.sqrt(d),
            torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"flash launch: {lib.flash_attention_error(rc)}")
        return out

    rows = {}
    for tag, (b, h, hkv, s, d, causal) in FLASH_COMPARE_SHAPES.items():
        q, k, v = _qkv(1, b, h, hkv, s, d, torch.bfloat16)
        want = ref.attention_ref(q, k, v, causal=causal).float()
        row = {"shape": [b, h, hkv, s, d], "causal": causal,
               "other_us": [], "this_us": [], "library_us": []}
        for name in libs:
            got = call(libs[name], q, k, v, causal).float()
            row[f"{name}_normwise_err"] = float(
                torch.linalg.vector_norm(got - want)
                / torch.linalg.vector_norm(want))
        del want
        lib = device_us(lambda: _sdpa(q, k, v, causal, 0), None)
        row["library_us"].append(lib["device_us_per_launch"])
        row["library_kernels"] = lib["device_kernels"]
        for name in ("other", "this", "this", "other"):
            row[f"{name}_us"].append(device_us(
                lambda: call(libs[name], q, k, v, causal),
                FLASH_KERNELS)["device_us_per_launch"])
        row["library_us"].append(device_us(
            lambda: _sdpa(q, k, v, causal, 0), None)["device_us_per_launch"])
        n_ops = b * h * _unmasked_pairs(s, causal, 0) * 4 * d
        row["bound_us"] = n_ops / PEAK_BF16_OPS_PER_S * 1e6
        rows[tag] = row
        emit("compare_flash", case=tag, **row)
        del q, k, v
    return rows


# the RG-LRU backward's shapes: griffin's train launch, a ragged one and the
# griffin smoke config's (train_sharded, elastic)
RG_LRU_COMPARE_SHAPES = {
    "train": (1, 4096, 2560),
    "ragged": (2, 1001, 1000),
    "smoke": (2, 256, 64),
}


def compare_rg_lru(other_source: str, reports: Dict[str, str]) -> dict:
    """Another ``rg_lru.cu`` (a parent commit's) against this checkout's
    RG-LRU backward, on one card: the other built with the same flags under
    another name, both held bit for bit to ``ref.rg_lru_bwd_ref`` at each
    of :data:`RG_LRU_COMPARE_SHAPES`, their device time a launch taken in
    the order other, this, this, other.  ``reports`` holds this checkout's
    ptxas logs where this process built it."""
    from repro_torch.kernels import rg_lru as rg
    other_so, log = _build_other("rg_lru", other_source)
    libs = {"other": rg._bind(ctypes.CDLL(str(other_so))),
            "this": _cuda_build.load("rg_lru", rg._bind)}
    emit("compare_rg_lru_build", ptxas={
        "other": _cuda_build.ptxas_summary(log),
        "this": _cuda_build.ptxas_summary(reports.get("rg_lru", "")) or None})

    def call(lib, a, y, g):
        b, s, w = g.shape
        da, dx = torch.empty_like(g), torch.empty_like(g)
        rc = lib.rg_lru_bwd_launch(a.data_ptr(), y.data_ptr(), g.data_ptr(),
                                   da.data_ptr(), dx.data_ptr(), b, s, w,
                                   torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"RG-LRU backward launch: {lib.rg_lru_error(rc)}")
        return da, dx

    rows = {}
    for tag, shape in RG_LRU_COMPARE_SHAPES.items():
        a, x = _gates(sum(shape), shape)
        y = ref.rg_lru_ref(a, x)
        g = torch.randn_like(y)
        da_want, dx_want = ref.rg_lru_bwd_ref(a, y, g)
        for name, lib in libs.items():
            da, dx = call(lib, a, y, g)
            check(torch.equal(da, da_want) and torch.equal(dx, dx_want),
                  f"RG-LRU backward ({name}) {shape}: not bit for bit with "
                  f"the plain reverse loop")
        row = {"shape": list(shape), "other_us": [], "this_us": []}
        for name in ("other", "this", "this", "other"):
            row[f"{name}_us"].append(device_us(
                lambda: call(libs[name], a, y, g),
                ("rg_lru_bwd_kernel",))["device_us_per_launch"])
        row["bound_us"] = 5 * g.numel() * 4 / PEAK_BYTES_PER_S * 1e6
        row["bound_share"] = row["bound_us"] / statistics.mean(row["this_us"])
        rows[tag] = row
        emit("compare_rg_lru", case=tag, **row)
    return rows


# the bf16 main-path training launches of the attention backward: (B, H,
# Hkv, S, D, causal, window); train_sharded's is train_dense's shape
FLASH_BWD_COMPARE_SHAPES = {
    "train": (1, 10, 1, 4096, 256, True, 2048),
    "train_dense": (1, 32, 8, 4096, 128, True, 0),
    "train_moe": (1, 16, 16, 4096, 128, True, 0),
    "train_small_encoder": (1, 12, 12, 1024, 64, False, 0),
    "train_small_decoder": (1, 12, 12, 4096, 64, True, 0),
}


def _bwd_launcher(lib):
    """A call of one build's ``flash_attention_bwd_launch`` on bf16 (q, k, v,
    o, lse, do, causal, window) returning (dq, dk, dv), and the distinct
    kernels a call runs: a build with ``flash_attention_bwd_scratch_floats``
    takes this checkout's arguments (a head split and sized scratch); an
    older one (the first design's) a float32 delta (B, H, S) and no
    split."""
    new_abi = hasattr(lib, "flash_attention_bwd_scratch_floats")
    fn = lib.flash_attention_bwd_launch
    fn.restype = ctypes.c_int
    if new_abi:
        from repro_torch.kernels import flash_attention as fa
        fa._bind_bwd(lib)
    else:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_bwd_error.argtypes = [ctypes.c_int]
    lib.flash_attention_bwd_error.restype = ctypes.c_char_p

    def split_of(q, k):
        b, h, s, d = q.shape
        return _bwd_head_split(
            b, h, k.shape[1], s, d, True,
            torch.cuda.get_device_properties(q.device).multi_processor_count) \
            if new_abi else 1

    def call(q, k, v, o, lse, do, causal, window):
        b, h, s, d = q.shape
        hkv = k.shape[1]
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), do.data_ptr())
        tail = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, hkv, s, d,
                1, int(causal), int(window))
        stream = torch.cuda.current_stream().cuda_stream
        if new_abi:
            split = split_of(q, k)
            n = lib.flash_attention_bwd_scratch_floats(b, h, hkv, s, d, 1,
                                                       split)
            scratch = torch.empty(n, dtype=torch.float32, device=q.device)
            rc = fn(*head, scratch.data_ptr(), *tail, split, n,
                    1.0 / math.sqrt(d), stream)
        else:
            delta = torch.empty((b, h, s), dtype=torch.float32,
                                device=q.device)
            rc = fn(*head, delta.data_ptr(), *tail, 1.0 / math.sqrt(d),
                    stream)
        check(rc == 0, f"attention backward launch: "
              f"{lib.flash_attention_bwd_error(rc)}")
        return dq, dk, dv

    return call, lambda q, k: 3 + (split_of(q, k) > 1)


def compare_flash_bwd(other_source: str, reports: Dict[str, str]) -> dict:
    """Another ``flash_attention_bwd.cu`` (a parent's, or a variant of this
    one) against this checkout's on one card: the other built with the
    same flags under another name, both held to ``ref.flash_attention_bwd_
    ref`` at the bf16 bars (2e-2 elementwise, 5e-3 normwise a gradient)
    and two calls bit for bit at each of :data:`FLASH_BWD_COMPARE_SHAPES`,
    their device time a launch in the order other, this, this, other, the
    library's backward's before and after.  Fails, after every shape,
    where this checkout's mean is not below the other's.  ``reports`` holds
    this checkout's ptxas logs where this process built it."""
    from repro_torch.kernels import flash_attention as fa
    other_so, log = _build_other("flash_attention_bwd", other_source)
    emit("compare_flash_bwd_build", ptxas={
        "other": _cuda_build.ptxas_summary(log),
        "this": _cuda_build.ptxas_summary(
            reports.get("flash_attention_bwd", "")) or None})
    launchers = {
        "other": _bwd_launcher(ctypes.CDLL(str(other_so))),
        "this": _bwd_launcher(_cuda_build.load(
            "flash_attention_bwd", fa._bind_bwd))}
    tol = FLASH_BWD_TOL[torch.bfloat16]
    rows, slower = {}, []
    for tag, (b, h, hkv, s, d, causal, window) in \
            FLASH_BWD_COMPARE_SHAPES.items():
        q, k, v = _qkv(2, b, h, hkv, s, d, torch.bfloat16)
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     return_lse=True)
        do = torch.randn(o.shape, generator=torch.Generator(
            device=DEVICE).manual_seed(3), device=DEVICE).to(torch.bfloat16)
        args = (q, k, v, o, lse, do, causal, window)
        row = {"shape": [b, h, hkv, s, d], "causal": causal,
               "window": window, "other_us": [], "this_us": [],
               "library_us": []}
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                           causal=causal, window=window)
        for name, (call, _) in launchers.items():
            got, again = call(*args), call(*args)
            _sync()
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  f"attention backward ({name}) {tag}: two calls differ")
            errs = {}
            for g, x, y in zip(("dq", "dk", "dv"), got, want):
                diff = (x.float() - y.float()).abs()
                errs[g] = float(torch.linalg.vector_norm(diff)
                                / torch.linalg.vector_norm(y.float()))
                check(bool((diff <= tol + tol * y.float().abs()).all())
                      and errs[g] <= FLASH_NORM_TOL,
                      f"attention backward ({name}) {tag}: {g} max abs err "
                      f"{float(diff.max())}, normwise {errs[g]}")
            row[f"{name}_normwise_err"] = errs
            del got, again
        del want
        lib = _sdpa_backward(q, k, v, do, causal, window)
        got = device_us(lib, None, reps=50, per_call=True)
        row["library_us"].append(got["device_us_per_launch"])
        row["library_kernels"] = got["device_kernels"]
        for name in ("other", "this", "this", "other"):
            call, kernels = launchers[name]
            got = device_us(lambda: call(*args), FLASH_BWD_KERNELS,
                            per_launch=kernels(q, k))
            row[f"{name}_us"].append(got["device_us_per_launch"])
            row[f"{name}_us_by_kernel"] = got["device_us_by_kernel"]
        row["library_us"].append(device_us(
            lib, None, reps=50, per_call=True)["device_us_per_launch"])
        del lib
        n_ops = b * h * _unmasked_pairs(s, causal, window) * 10 * d
        row["bound_us"] = n_ops / PEAK_BF16_OPS_PER_S * 1e6
        this, other = (statistics.mean(row[f"{n}_us"])
                       for n in ("this", "other"))
        row.update(bound_share=row["bound_us"] / this,
                   vs_library=this / statistics.mean(row["library_us"]),
                   vs_other=this / other)
        if this >= other:
            slower.append(tag)
        rows[tag] = row
        emit("compare_flash_bwd", case=tag, **row)
        del q, k, v, o, lse, do, args
        torch.cuda.empty_cache()
    check(not slower, f"attention backward: this checkout's kernel is not "
          f"faster than the other at {slower}")
    return rows


# the LM head's products at the training cells' micro-batch (T, d, V)
LM_HEAD_CELLS = {"internlm2-20b": (4096, 6144, 92544),
                 "mistral-7b": (4096, 4096, 32000)}


def phase_lm_head() -> dict:
    """The LM head's three kernels (``kernels/lm_head.py``) at the training
    cells' micro-batch shapes: each launch's CUDA-event ms around the
    wrapper and device µs (``torch.profiler``); its bound, the product's
    operations (2*T*d*V) at 989 TFLOP/s, the roofline; its floor, the
    operations the kernel's algorithm runs (one bf16 pass for the forward,
    three for each backward product: the cost of float32's precision) at
    the same rate; the TFLOP/s of those passes; the plain version's ms (the
    float32 product through cuBLAS, TF32 off, and its cast: the path the
    kernels replaced) and its float32 bound (67 TFLOP/s); the largest error
    of each against a float64 product, which the kernel must hold to twice
    the plain version's.  Each cell's summary gives the three launches'
    device ms against the summed bound (``bound_share``, the roofline
    share) and floor (``floor_share``), and the phase's seconds."""
    rows = {}
    for cell, (t, d, v) in LM_HEAD_CELLS.items():
        t0 = time.perf_counter()
        gen = torch.Generator(device=DEVICE).manual_seed(t + d + v)
        x = torch.randn((t, d), generator=gen, device=DEVICE).to(
            torch.bfloat16)
        w = (torch.randn((d, v), generator=gen, device=DEVICE) * 0.02).to(
            torch.bfloat16)
        dl = torch.softmax(torch.randn((t, v), generator=gen, device=DEVICE),
                           dim=-1) / t
        calls = {
            "fwd": (lambda: _lm_head_fwd(x, w), lambda: ref.lm_head_fwd_ref(
                x, w), lambda: x.double() @ w.double(), 1),
            "dx": (lambda: _lm_head_dx(dl, w), lambda: ref.lm_head_dx_ref(
                dl, w), lambda: dl.double() @ w.double().t(), 3),
            "dw": (lambda: _lm_head_dw(x, dl), lambda: ref.lm_head_dw_ref(
                x, dl), lambda: x.double().t() @ dl.double(), 3),
        }
        row: Dict[str, dict] = {}
        for name, (kernel, plain, exact, passes) in calls.items():
            want = exact()
            errs = [float((f().double() - want).abs().max())
                    for f in (kernel, plain)]
            del want
            check(errs[0] <= 2.0 * errs[1],
                  f"lm_head {cell} {name}: largest error {errs[0]} against "
                  f"the float32 product's {errs[1]}")
            ops_n = 2 * t * d * v
            got = device_us(kernel, LM_HEAD_KERNELS, reps=10)
            ms = time_ms(kernel)
            row[name] = dict(
                ms=ms, device_us_per_launch=got["device_us_per_launch"],
                device_traced=got["device_traced"],
                bound_ms=ops_n / PEAK_BF16_OPS_PER_S * 1e3,
                bound_by="operations",
                floor_ms=passes * ops_n / PEAK_BF16_OPS_PER_S * 1e3,
                tflops=passes * ops_n / (got["device_us_per_launch"] * 1e-6)
                / 1e12,
                plain_ms=time_ms(plain),
                plain_bound_ms=2 * t * d * v / PEAK_FP32_OPS_PER_S * 1e3,
                max_abs_err=errs[0], plain_max_abs_err=errs[1])
            torch.cuda.empty_cache()
        total_us = sum(r["device_us_per_launch"] for r in row.values())
        summary = dict(
            shape=[t, d, v], device_ms=total_us / 1e3,
            bound_ms=sum(r["bound_ms"] for r in row.values()),
            floor_ms=sum(r["floor_ms"] for r in row.values()),
            plain_ms=sum(r["plain_ms"] for r in row.values()))
        summary["bound_share"] = summary["bound_ms"] / summary["device_ms"]
        summary["floor_share"] = summary["floor_ms"] / summary["device_ms"]
        summary["seconds"] = time.perf_counter() - t0
        rows[cell] = dict(row, **summary)
        emit("lm_head", case=cell, **rows[cell])
        del x, w, dl, calls
        torch.cuda.empty_cache()
    return rows


EXPERIMENT_JOBS = 1000
MAIN_PATH_FLASH = ("flash_serve", "flash_train", "flash_serve_dense",
                   "flash_train_dense", "flash_serve_moe", "flash_train_moe",
                   "flash_serve_encdec_encoder", "flash_serve_encdec_decoder",
                   "flash_train_small_encoder", "flash_train_small_decoder",
                   "flash_serve_sharded", "flash_train_sharded",
                   "flash_train_sharded_griffin", "flash_elastic")
MAIN_PATH_FLASH_BWD = ("flash_bwd_train", "flash_bwd_train_dense",
                       "flash_bwd_train_moe", "flash_bwd_train_small_encoder",
                       "flash_bwd_train_small_decoder",
                       "flash_bwd_train_sharded",
                       "flash_bwd_train_sharded_griffin", "flash_bwd_elastic")


def main(argv: Sequence[str]) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if argv == ["--lm-head"]:
        info = phase_device()
        phase_build()
        phase_lm_head()
        print(info["nvidia_smi"], flush=True)
        return 0
    compares = {"--compare-flash": lambda path, _: compare_flash(path),
                "--compare-rg-lru": compare_rg_lru,
                "--compare-flash-bwd": compare_flash_bwd}
    if argv[:1] and argv[0] in compares and len(argv) == 2:
        info = phase_device()
        reports = _cuda_build.build_all()
        compares[argv[0]](argv[1], reports)
        print(info["nvidia_smi"], flush=True)
        return 0
    check(not argv, f"arguments {list(argv)}: none, --lm-head, "
          "--compare-flash "
          "PATH_OF_ANOTHER_flash_attention.cu, --compare-rg-lru "
          "PATH_OF_ANOTHER_rg_lru.cu or --compare-flash-bwd "
          "PATH_OF_ANOTHER_flash_attention_bwd.cu")

    t_start = time.perf_counter()
    info = phase_device()
    ptxas = phase_build()
    launches: Dict[str, int] = {}
    corpus, loop, planner = Recorder(keep=64), Recorder(), Recorder()
    grid, figures, robust = Recorder(), Recorder(), Recorder()
    recs = {name: Recorder() for name in (
        "serve", "train", "serve_dense", "train_dense", "serve_moe",
        "train_moe", "serve_encdec", "train_small", "train_sharded",
        "train_sharded_griffin", "serve_sharded", "elastic")}
    phase_trace_corpus(launches, corpus)
    phase_experiment(launches, loop, EXPERIMENT_JOBS)
    phase_paper_grid(launches, grid, EXPERIMENT_JOBS)
    phase_paper_figures(launches, figures)
    phase_robustness(launches, robust)
    phase_planner(launches, planner)
    phase_lm_head()
    phase_serve(launches, recs["serve"])
    phase_train(launches, recs["train"])
    phase_serve(launches, recs["serve_dense"], SERVE_DENSE, "serve_dense")
    phase_serve(launches, recs["serve_moe"], SERVE_MOE, "serve_moe")
    dry = DryRun()  # host-side cells, beside two device-bound phases
    try:
        phase_train(launches, recs["train_dense"], TRAIN_DENSE,
                    "train_dense")
        phase_train(launches, recs["train_moe"], TRAIN_MOE, "train_moe")
        phase_dryrun(dry)
    finally:
        dry.stop()
    # xLSTM's path launches no kernel: its recorder holds no case
    phase_serve(launches, Recorder(), SERVE_XLSTM, "serve_xlstm")
    phase_serve(launches, recs["serve_encdec"], SERVE_ENCDEC, "serve_encdec")
    for spec in TRAIN_SMALL:
        phase_train(launches, recs["train_small"], spec,
                    f"train_small_{spec['arch']}")
    phase_train_sharded(launches, recs["train_sharded"],
                        recs["train_sharded_griffin"])
    phase_serve_sharded(launches, recs["serve_sharded"])
    phase_elastic(launches, recs["elastic"])
    cases = phase_kernels(corpus, loop, grid, figures, robust, planner,
                          recs)
    print(json.dumps(_digits(kernel_summary(launches, cases, ptxas))),
          flush=True)
    emit("total", seconds=time.perf_counter() - t_start, launches=launches)
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
