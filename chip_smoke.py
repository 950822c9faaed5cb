"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100 is what it was written for), ``nvcc`` and
this checkout; imports only ``repro_torch``, torch and numpy.  Phases, any
failure of which exits non-zero:

1. device: the card's name and power limit, torch's device name and count;
2. build: every ``csrc/*.cu`` with nvcc for sm_90a, and the ``-Xptxas -v``
   register / shared-memory / spill lines, then the tensor-core kernels'
   (W8's too) and the FFMA narrow decode tile's (K1 and K2) registers,
   spills and dynamic shared memory at the main path's shapes, and the
   narrow tile's width at every fp32-x K1 decode site (float and W8) and
   at the int8 MoE banks (K2's int8-only form, fp32 and bf16 x), the
   W8A8 narrow tile's width and shared memory at every W8A8 decode site,
   and the W8A8 int8 tensor-core tile's (and its quantize pass's)
   registers and spills, and its width, shared memory and scratch at
   every W8A8 prefill-chunk site (more than 16 rows);
3. GEMM kernel checks: each K1/K2 form against its plain PyTorch version
   at every site shape of full-width qwen2-0.5b's main path, at decode
   (M = 4) and at one prefill chunk, and of full-width qwen3-moe-30b-a3b's
   path at decode (its attention and unembed GEMMs, the router on fp32 K1,
   and moe.wi_gate / wi_up / wo on K2 with 128 experts of one capacity row
   each), and of full-width mamba2-370m's K1 sites (mamba.z, mamba.xbc,
   mamba.dt at N = 32, mamba.out, the unembed) at decode and at its
   full-sequence prefill (M = 2048), in bf16 and fp32, k in {1, 2, 4},
   each epilogue flag at least once; then the kernel, the plain version
   and one PyTorch library call timed with CUDA events, beside the least time the card could take (the
   bound).  bf16 float-form K1 and K2 and the bf16-x W8 K1 run the
   tensor-core kernels, fp32 the FFMA kernels (``gemm_kernel`` /
   ``gemm_q_kernel`` / ``expert_gemm_kernel``): each check and time is
   booked under the kernel that ran, and the decode sites of the float K1,
   the float K2 and the W8 K1 are timed in fp32 as well (the FFMA kernels,
   which only the fp32 path runs).  First the float forms (the ``arrayflex`` backend), then the
   int8 forms at the sites of ``arrayflex_int8`` (W8, with the expert banks
   on K2's int8-only form, each bank's narrow-tile width held to the
   written rule) and ``arrayflex_w8a8`` (W8A8, with attn.qk and the expert
   banks on K2's W8A8 form, each decode site's W8A8 narrow-tile width held
   to the same rule; at each prefill-chunk site, more than 16 rows, the
   device time of the quantize pass alone beside the whole launch's, with
   the int8 tensor-core tile's width and shared memory), and the
   plain-torch K^T quantize that attn.qk runs under W8A8;
4. flash attention (K3): ``ops.attention`` at every case of
   :data:`K3_CASES` (the launch counter set to 0 just before and read just
   after: one launch each), each output held against
   ``flash_attention_plain`` on the same inputs; then the kernel, the plain
   version and ``scaled_dot_product_attention`` timed, beside the bound;
   every bf16 case must have launched the tensor-core kernel (the ragged
   one on its KV-split path), the fp32 cases the FFMA kernel;
5. serving: full-width qwen2-0.5b with random weights (seed 0) served in
   bf16 through ``ServingEngine`` on ``arrayflex``, then on
   ``arrayflex_int8`` and ``arrayflex_w8a8``; then full-width
   qwen3-moe-30b-a3b (bf16 parameters, token-by-token prefill) on
   ``arrayflex`` at all 48 layers and on the two int8 backends at 24 (a
   48-layer bf16 tree and its int8 copy do not fit one 80 GB card
   together), and full-width mamba2-370m (bf16 parameters, token-by-token
   prefill, 193 K1 launches a step and no K2) on the three backends:
   every request must finish with its tokens and finite
   logits, and each run's kernel launch counters (set to 0 just before
   it) must equal its forms' launches per step (each layer's sites from
   ``lm.sublayer_kind``: :func:`step_sites`) times the steps, every
   bf16 K1 and K2 launch (the W8 K1's too) on the tensor-core kernels;
   then mamba2 once more with a GEMM fault at its last layer's mamba.out
   in the first token-prefill step (every dispatch drawing) and a NaN at
   the first sampling, both retried: streams equal to the clean run's,
   with the stream time of the two retry designs the step does not take
   (per-layer copies of its recurrent leaves, a save of them);
   then paged serving of full-width qwen2-0.5b (page
   ``planner.page_plan(256)`` = 128, every run's counters checked the same
   way, its prefill K1/K2 launches too): (a) the same requests on each
   backend from a pool that reserves each in full, greedy streams equal
   to the dense runs' bit for bit on ``arrayflex`` and ``arrayflex_int8``
   (``arrayflex_w8a8``: printed, and two paged runs identical), with
   ``kv_cache_bytes`` and the paged decode step's host-clock and
   device-busy time beside the dense one's, and one step of each timed
   alone in turns; (b) eight short requests at ``max_batch`` 4, all
   resident at once (``concurrency_peak`` 8), every page returned; (c)
   eight requests sharing a 128-token system prompt, the followers
   arriving once the first has decoded, cold, warm (the radix prefix
   cache), warm, cold: equal streams, fewer prefill tokens and launches;
   every chaos-free run's requests must end ``ok`` with no retry and no
   watchdog (a kernel that emits NaN fails the run); then the resilient
   engine on full-width qwen2-0.5b (``resilience_phase``): (a) chaos
   seeded but quiet with snapshots every 2 ticks, (b) a transient GEMM
   fault at layer 0's attn.pv of the first prefill trace and then of the
   first decode trace, (c) a transient NaN, (d) a crash mid-decode
   restored from a snapshot taken every tick (the crashed engine released
   first: one engine's memory at the peak), dense on ``arrayflex`` and
   ``arrayflex_int8`` and paged with the prefix cache, with the snapshot
   and restore times, (e) preemption (``preempt_policy="youngest"``) on
   a pool below the batch's worst case, with the prefill tokens
   recomputed, (f) persistent GEMM faults, then persistent NaNs: every
   request ``failed``, no hang; every stream equals its clean run's, the
   outcome counters sum to the requests, and every run's launches equal
   the per-step counts times the dispatches that ran in full plus what
   each faulted attempt launched before its faulted site
   (``retried_launches``); then one decode step alone against one retried
   after a fault, in turns; then disaggregated serving
   (``disagg_phase``: ``DisaggServingEngine``, 1 + 1 pods, pp = 1): (a)
   the same requests on each backend with the prefill chunk pinned to
   the colocated one, streams equal bit for bit, ``kv_transfer_bytes``
   the handoffs times a row's bytes; (b) ``arrayflex`` with the prefill
   role's re-picked chunk, its first divergence from colocated printed
   (phase 7 holds the same run in fp32 to the fp32 colocated streams);
   (c) paged, against the paged run, the live pages moved; (d) a
   ``transfer.kv`` drop retried, a persistent drop (``failed``,
   ``TransferFault``), a ``disagg.pod`` loss (``preempted_retried``,
   (a)'s streams); (e) one decode step under ``pp_role="decode",
   pp_stages=2`` (no mesh): attn.wq launched at the role's k, logits equal
   the colocated step's; every run's launches checked per step; each run
   prints the role clocks, the makespan against the colocated sum, each
   request's virtual TTFT against the colocated wall TTFT and its
   handoff's time and bytes; then the mesh (``mesh_phase``, over four
   logical devices: four views of the one card, each shard of a sharded
   dispatch its own K1 / K2 launch at the shard's shapes): (a) the
   engine at ``mesh_shape`` (1, 2) and (2, 2) on the three backends in
   bf16, launches held to :func:`mesh_launches` (shards x per-site
   launches x steps, from the shard contexts), streams against the
   unsharded runs (a moved bf16 stream reported); (b) fp32 on
   ``arrayflex`` and ``arrayflex_int8``: streams equal the unsharded
   fp32 engine's and one decode step's logits within the reference's
   sharded tolerance (rtol 1e-4, atol 1e-3); (c) the weight-block memo's
   bytes and a decode step with it cold and warm; (d) every K1 / K2
   launch of a tp 2 decode step held to its plain version at the
   shard's shape and k (kernel_tol) and timed, the (2, 2) ones held too;
   (e) one expert-parallel decode step of qwen3-moe-30b-a3b (4 layers)
   and one mamba2-370m decode step at tp 2, fp32, against their
   unsharded steps; then the pipeline (``pp_phase``:
   ``DisaggServingEngine`` with 2 + 2 pods at pp = 2, dense K/V, the
   three backends and fp32, chunk pinned): launches a step equal the
   colocated step's, attn.wq at each role's k (the pinned role table),
   streams equal colocated (W8A8 where a role re-picks k: reported, and
   two runs equal), handoff bytes and times;
6. full-sequence prefill: full-width qwen2-0.5b ``lm.prefill`` on
   ``arrayflex``/bf16, B = 1, at S = 2048 (dense attention: attn.qk on K2
   at g * S = 14336 rows) and S = 4096 (the chunked scan), each run's
   launch counters set to 0 just before it and read just after (K1 and K2
   per layer, never K3; every launch on the tensor-core kernels), with
   its host-clock time, device-busy time and peak memory; then
   full-width mamba2-370m ``lm.prefill`` at S = 2048 (8 SSD chunks of
   256) the same way (4 K1 launches a layer and the unembed);
7. model parity: one ``prefill_step`` + ``decode_step`` on the kernels
   against the ``ref`` backend on the card, in bf16 and in fp32; then
   ``arrayflex_int8`` against ``ref`` on the dequantized weights (its
   launch counters set to 0 just before and read just after: every W8 K1
   launch on the FFMA kernel), and ``arrayflex_w8a8`` against fp32
   ``arrayflex``, both in fp32; the disaggregated run with the re-picked
   chunk against a colocated one in fp32 (streams equal); then the
   full-width prefill of phase 6 in fp32 against ``ref`` and against the
   engine's chunked ``prefill_step`` path on the same tokens (the kernels'
   run with its launch counters set to 0 just before and read just after:
   every launch on the FFMA kernels); then the
   same three decode pairs on qwen3-moe-30b-a3b in fp32 at full width and
   4 layers, and its ``lm.prefill`` at S = 256 on the kernels against
   ``ref``, each reporting whether both runs routed every token to the
   same experts at every layer (the W8 run counted as above); the fp32
   runs launch the FFMA K1 only; then full-width mamba2-370m in fp32
   (decode steps and ``lm.prefill`` at S = 2048 against ``ref``, counted;
   the max_batch=1 anchor: one request alone, its decode-by-decode logits
   against ``lm.forward``'s within the ``ref`` backend's own gap plus
   BF16_WINDOW_TOL), and reduced jamba-1.5-large-398b in fp32 against
   ``ref`` (decode counted: K1 and K2, the attention products and the
   expert banks, per step from :func:`step_sites`); then the last
   families and the three dense archs (``family_phase``), each at full
   published width in bf16 parameters, one tree at a time:
   mixtral-8x22b (8 of 56 layers on ``arrayflex``, 6 on the int8
   backends; its window cut to 16 for serving, so that the ring wraps in
   the prompts), llama-3.2-vision-90b (10 of 100 layers: 8 self-attention,
   2 cross), whisper-base (6 + 6 layers), llama3-8b, qwen2.5-14b and
   stablelm-12b (all layers): each served on the three backends (token
   prefill for the families, batched for the dense archs; launches per
   step from :func:`step_sites`, which adds a cross layer's xattn.wq,
   attn.qk, attn.pv and xattn.wo; the decode step profiled, peak
   memory), the K1 / K2 launches of one decode step and one prefill chunk
   recorded at the shapes, flags and k the path gave them
   (``recorded_sites``); the families' ``lm.prefill`` at B = 1 on
   ``arrayflex`` (mixtral S = 4608 at its published window 4096: a ring
   of 4096 rolled by 512, the chunked scan; the vlm S = 512 against 1600
   image tokens: ``frontend.img``, ``xattn.kv`` at 1600 rows, K2 at 1600
   keys; whisper 64 tokens against 1500 encoded frames), counted
   (``forward_launches``), timed, profiled; then, each tree freed, every
   recorded site checked against its plain version at its k in bf16 and
   fp32 (head_dim 128 and 160, the 1500- and 1600-key cross products
   among them) and timed; and fp32 parity against ``ref``
   (:data:`PARITY_LAYERS`: the families' ``lm.forward`` with its context
   and six decode steps, mixtral through a ring of 4, counted; the dense
   archs' ``prefill_step`` + ``decode_step``);
   Then training (``train_phase``; the ``xla`` backend, so no kernel
   and no launch: the collapse backends have no backward pass): (a)
   full-width qwen2-0.5b (fp32 parameters, bf16 compute) takes 10 AdamW
   steps at B = 8, S = 256 on ``SyntheticLM`` (seed 0,
   ``OptConfig(warmup_steps=2)``): every loss and gradient norm finite,
   every parameter leaf changed, the last loss below the first; its step
   time (host clock), tokens/s, peak memory and one step's device busy
   and idle share (torch.profiler), then one ``n_microbatches=2`` step
   against the single step on one state and batch (loss within 1e-3,
   every new parameter within 2 x lr);
   (b) full-width mamba2-370m (the SSD backward) for 4 steps and
   qwen3-moe-30b-a3b at 2 of 48 layers for 3 (the experts' moments
   nonzero, the aux loss positive), the same checks; (c) 2 layers of
   full-width qwen2-0.5b in fp32 (B = 2, S = 64, TF32 off): the loss and
   every gradient leaf on the card against the port's CPU run on the same
   tree and tokens (1e-5; 1e-4 of each leaf's max |g|); (d) that model 8
   steps under ``FaultToleranceManager`` (checkpoints every 3 steps in a
   temporary directory, a failure before step 5) under deterministic
   algorithms (``CUBLAS_WORKSPACE_CONFIG`` set at import): the steps run
   follow :func:`restart_schedule` and the final parameters and optimizer
   state equal an uninterrupted run's bit for bit; then
   (``mesh_train_phase``) (e) full-width qwen2-0.5b through
   ``launch.train.main`` at its defaults for 4 steps under
   ``host_devices(4)``, unsharded and at ``--mesh-data 2 --mesh-model
   2`` and (1, 2): every step's loss within 5e-3 of the unsharded run's,
   the median step (host clock), peak memory, the weight-block memo's
   bytes (0: a weight requiring a gradient bypasses it) and the
   constrained activations a step; (f) the fp32 cell of (c) sharded at
   (2, 2) against unsharded on the card: the loss (1e-5), every gradient
   leaf (1e-4 of its max), and one step at n = 1 and n = 2: the loss,
   every first moment (1e-4), every parameter (within 2 x lr); (g) remat
   "full" against "none" at the defaults: loss and gradients bit for bit
   under deterministic algorithms, the forward + backward's peak and a
   step's time and peak for each; (h) ``compress`` /
   ``compressed_allreduce`` over four shards on the card against the
   CPU, bit for bit;
8. summary: each form's totals per decode step of each model, per
   prefill-chunk step of qwen2-0.5b and per mamba2-370m prefill, one
   JSON line of kernel numbers, the card's name and power limit, and the
   ``{"ok": true, ...}`` line last.  Each site check's error, the plain
   version's scale and the tolerance go to the JSON report
   (``site_checks``); a bf16 check one step above KERNEL_TOL at a site
   TC_FLIP_SITES does not name fails the run here, after every phase.

Detailed results also go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# the training phase's restart check runs under deterministic algorithms,
# which need cuBLAS's fixed workspace from its first call on
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import arrayflex_gemm as ag  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.kernels import build, ops, substrate  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import api, lm  # noqa: E402
from repro_torch.nn import moe  # noqa: E402
from repro_torch.runtime.chaos import ChaosConfig, ChaosEngine  # noqa: E402
from repro_torch.optim import OptConfig, adamw_init  # noqa: E402
from repro_torch.runtime import chaos  # noqa: E402
from repro_torch.runtime import (FaultToleranceManager,  # noqa: E402
                                 HeartbeatMonitor)
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.serving import (DisaggServeConfig,  # noqa: E402
                                 DisaggServingEngine, EngineCrash,
                                 KernelFault, Request, ServeConfig,
                                 ServingEngine)
from repro_torch.serving.engine import PREFILL_CHUNK_CHOICES  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12,
                  torch.int8: 1979e12}

# Tolerances, relative to the largest |value| of the plain version's output:
# fp32 — the kernel and the plain version differ only in the order of the
# fp32 sums over K (<= 4864 terms), far inside 1e-5; bf16 — the two fp32
# results may round to neighbouring bf16 values, one bf16 step (2^-8
# relative) at the largest magnitude.
KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8}


def step_tol(dt, scale: float) -> float:
    """Absolute tolerance at max |plain| ``scale`` (floored at 1): in bf16
    the bf16 step exactly at that magnitude, 2^(floor(log2 scale) - 7)
    (two fp32 results may round to neighbouring bf16 values), which 2^-8
    of it understates by up to 2x just below a power of two; in fp32
    KERNEL_TOL.  The int8 forms, K3 and the full-sequence prefill's K1/K2
    sites (where the residual-joined mlp.wo reaches |value| ~8) use it."""
    scale = max(scale, 1.0)
    if dt == torch.bfloat16:
        return 2.0 ** (math.floor(math.log2(scale)) - 7)
    return KERNEL_TOL[dt] * scale


# Float sites whose bf16 check on the tensor-core K1 exceeds KERNEL_TOL by
# one rounding flip at the largest magnitude (the error is exactly the bf16
# step of the top binade, 2^(floor(log2 scale) - 7): the tensor cores add
# the fp32 products in another order, and with other rounding, than the
# plain version's fp32 matmul): (cell, site, shape), on these seeded
# inputs.  They take step_tol, whose docstring gives the reason.
TC_FLIP_SITES = {
    ("qwen2-0.5b", "attn.wq", (1024, 896, 896)),
    ("qwen2-0.5b", "mlp.wo", (1024, 4864, 896)),
    ("qwen3-moe-30b-a3b", "attn.wo", (4, 4096, 2048)),
    # the SSM cell, at decode and at its full-sequence prefill
    ("mamba2-370m", "mamba.out", (4, 2048, 1024)),
    ("mamba2-370m", "mamba.xbc", (2048, 1024, 2304)),
    # the last families and the dense archs, at their recorded sites
    ("llama-3.2-vision-90b", "attn.wk", (4, 8192, 1024)),
    ("llama3-8b", "attn.wq", (1024, 4096, 4096)),
    ("llama3-8b", "mlp.wo", (1024, 14336, 4096)),
    ("qwen2.5-14b", "attn.wo", (4, 5120, 5120)),
    ("qwen2.5-14b", "attn.wq", (1024, 5120, 5120)),
    ("qwen2.5-14b", "attn.wk", (1024, 5120, 1024)),
    ("qwen2.5-14b", "attn.wv", (1024, 5120, 1024)),
    ("qwen2.5-14b", "mlp.wo", (1024, 13824, 5120)),
    ("stablelm-12b", "attn.wo", (4, 5120, 5120)),
    ("stablelm-12b", "attn.wq", (1024, 5120, 5120)),
    ("stablelm-12b", "mlp.wi_gate+mlp.wi_up", (1024, 5120, 13824)),
    ("stablelm-12b", "mlp.wo", (1024, 13824, 5120)),
}


def kernel_tol(site, dt, scale: float) -> float:
    """Absolute tolerance of a decode / prefill-chunk site's check: the
    int8 forms and TC_FLIP_SITES take :func:`step_tol`; the other float
    sites keep KERNEL_TOL."""
    if (site.form != "float"
            or (site.cell, site.name, tuple(site.shape)) in TC_FLIP_SITES):
        return step_tol(dt, scale)
    return KERNEL_TOL[dt] * max(scale, 1.0)


# every site check: (cell, site, shape, form, dtype, k, max abs error, the
# plain version's max |value| (scale), tolerance), in the JSON report
SITE_CHECKS = []
# float bf16 checks above KERNEL_TOL by exactly one bf16 step at the top
# binade at a site TC_FLIP_SITES does not name: each fails the run at its
# end, after every phase has run, so that one run lists them all
UNLISTED_FLIPS = []
# Model logits, relative to max |ref logit|: fp32 (with an fp32 K/V cache,
# so no bf16 rounding enters) — summation order through 24 layers; bf16
# (bf16 cache, as served) — hidden states are rounded to bf16 after every
# GEMM, so a one-step rounding flip in an early layer propagates: 16 bf16
# steps.
MODEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 16 * 2.0 ** -8}
# W8 against ref on the dequantized weights, relative to max |ref logit|:
# the reference's W8 contract (docs/substrate.md: the int8 dispatch equals
# the fp32 path on dequantized weights up to summation order), in fp32.
W8_PARITY_TOL = 1e-4
# W8A8 against fp32 arrayflex, relative to max |fp32 logit|: the
# reference's dense W8A8 tolerance is 0.12 absolute on its reduced
# qwen2-0.5b, whose fp32 logits peak at 0.513 (tests/test_torch_quant.py's
# config), so the policy admits 0.12 / 0.513 of the logit scale.
W8A8_PARITY_TOL = 0.12 / 0.513
# W8A8 MoE against fp32 arrayflex, relative to max |fp32 logit|: the
# reference's MoE W8A8 tolerance is 2.5 absolute on its reduced
# qwen3-moe-30b-a3b (router top-k flips amplify the quantization noise),
# whose fp32 logits peak at 3.053 in tests/test_torch_moe.py's decode steps
W8A8_MOE_PARITY_TOL = 2.5 / 3.053

BATCH, MAX_SEQ, MAX_NEW = 4, 256, 16
PROMPT_LENS = (32, 64, 96, 128)
# the MoE cell: prompts prefilled token by token, fewer new tokens, depth
# cut to 24 layers for the int8 backends and 4 for the fp32 parity runs
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_MAX_SEQ, MOE_MAX_NEW = 64, 8
MOE_PROMPT_LENS = (8, 12, 16, 24)
MOE_QUANT_LAYERS, MOE_PARITY_LAYERS, MOE_PARITY_STEPS = 24, 4, 4
# the MoE full-sequence prefill checked in fp32 at MOE_PARITY_LAYERS
MOE_FWD_SEQ = 256
# the SSM cell: full-width mamba2-370m, prompts prefilled token by token
# (its only mode), a full-sequence prefill of SSM_FWD_SEQ tokens (8 chunks
# of 256), SSM_PARITY_STEPS fp32 decode steps against ref; and the hybrid
# at reduced size, fp32, against ref
SSM_ARCH = "mamba2-370m"
SSM_MAX_SEQ, SSM_MAX_NEW = 64, 8
SSM_PROMPT_LENS = (8, 12, 16, 24)
SSM_FWD_SEQ = 2048
SSM_PARITY_STEPS = 4
HYBRID_ARCH = "jamba-1.5-large-398b"
HYBRID_STEPS, HYBRID_FWD_SEQ = 4, 32
# the bf16 conv window's share of a decode-vs-forward gap: two runs that
# differ in fp32 rounding may round a window value to neighbouring bf16
# values (tests/test_torch_ssm_model.py's bf16-window tolerance)
BF16_WINDOW_TOL = 1e-3


def log(msg=""):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: kernels at the main path's shapes

@dataclasses.dataclass
class Site:
    name: str
    kernel: str             # "arrayflex_gemm" | "arrayflex_expert_gemm"
    shape: tuple            # (M, K, N) or (E, T, K, N)
    per_step: int           # launches per decode/prefill step
    flags: dict = dataclasses.field(default_factory=dict)
    copies: int = 24        # distinct weight copies timed in turn (layers)
    form: str = "float"     # "float" | "int8" (W8) | "w8a8"
    cell: str = "qwen2-0.5b"
    time_dtype: torch.dtype = torch.bfloat16   # the path's dtype here
    k: int = 0              # the path's k (0: the substrate's plan)

    @property
    def launch_name(self) -> str:
        """The wrapper's ``LAUNCHES`` key for this site's kernel form."""
        return self.kernel if self.form == "float" else \
            f"{self.kernel}_{self.form}"

    def kernel_key(self, dt) -> str:
        """The kernel that runs this site on operands of ``dt``: the
        float-form K1 and K2 and the W8 K1 on bf16 are the tensor-core
        kernels (``gemm_kernel`` / ``expert_gemm_kernel`` /
        ``gemm_q_kernel``; K2's fp32 query meets a bf16 cache on the FFMA
        kernel); every other form has one kernel."""
        if (self.form == "int8" and self.kernel == "arrayflex_gemm"
                and ag.gemm_q_kernel(dt, False) == "af_gemm_q_tc"):
            return "arrayflex_gemm_int8_tc"
        if self.form == "float" and dt == torch.bfloat16:
            if (self.kernel == "arrayflex_gemm"
                    and ag.gemm_kernel(dt) == "af_gemm_tc"):
                return "arrayflex_gemm_tc"
            if (self.kernel == "arrayflex_expert_gemm"
                    and ag.expert_gemm_kernel(dt, dt) == "af_expert_gemm_tc"):
                return "arrayflex_expert_gemm_tc"
        return self.launch_name


# the FFMA kernels that only fp32 x runs (the float forms' and the W8
# K1's): booked with their fp32 checks, their decode sites timed in fp32
FFMA_FP32 = ("arrayflex_gemm", "arrayflex_expert_gemm", "arrayflex_gemm_int8")

# the narrow FFMA tile's grid that fills the card (csrc/arrayflex_gemm.cu
# NW_FILL): one block on all but 4 of an H100's 132 SMs
NARROW_FILL = 128


def narrow_int8_cols(M: int, N: int, batch: int = 1) -> int:
    """The narrow tile's width on int8 codes (csrc/arrayflex_gemm.cu
    ``nw_cols``), K1 at M rows or K2's int8-only form at T = M rows of
    ``batch`` experts: the widest of 128 (M <= 4 only), 64 and 32 columns
    whose grid, ceil(N / width) blocks x batch, fills the card, else 16."""
    def fills(cols):
        return -(-N // cols) * batch >= NARROW_FILL
    if M <= 4 and fills(128):
        return 128
    return 64 if fills(64) else 32 if fills(32) else 16


# kernel form -> the backend whose plans (k) the form runs under
FORM_BACKEND = {"float": "arrayflex", "int8": "arrayflex_int8",
                "w8a8": "arrayflex_w8a8"}


def main_path_sites(cfg, rows: int, max_seq: int = MAX_SEQ):
    """Every GEMM one step of ``cfg``'s path launches outside the MoE
    sites (:func:`moe_sites`), with ``rows`` token rows per dispatch (B
    at decode, B * chunk at prefill) against a K/V cache of ``max_seq``."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    L, V, ff = cfg.n_layers, cfg.padded_vocab, cfg.d_ff
    g, S = H // KV, rows // BATCH
    qkv = dict(bias=cfg.qkv_bias, norm_scale=True)
    sites = [
        Site("attn.wq", "arrayflex_gemm", (rows, d, H * hd), L, qkv),
        Site("attn.wk", "arrayflex_gemm", (rows, d, KV * hd), L, qkv),
        Site("attn.wv", "arrayflex_gemm", (rows, d, KV * hd), L, qkv),
        Site("attn.wo", "arrayflex_gemm", (rows, H * hd, d), L),
    ]
    if cfg.moe is None:
        sites += [
            Site("mlp.wi_gate+mlp.wi_up", "arrayflex_gemm", (rows, d, ff), L,
                 dict(dual=True, activation="silu", norm_scale=True)),
            Site("mlp.wo", "arrayflex_gemm", (rows, ff, d), L,
                 dict(residual=True)),
        ]
    sites += [
        # prefill unembeds only each row's last token: B rows; a tied
        # table accumulates to fp32 logits, an untied lm_head is a linear
        Site("unembed", "arrayflex_gemm", (BATCH, d, V), 1,
             dict(out_f32=True) if cfg.tie_embeddings else {}, copies=1),
        Site("attn.qk", "arrayflex_expert_gemm",
             (BATCH * KV, g * S, hd, max_seq), L, dict(out_f32=True)),
        Site("attn.pv", "arrayflex_expert_gemm",
             (BATCH * KV, g * S, max_seq, hd), L),
    ]
    return [dataclasses.replace(s, cell=cfg.name) for s in sites]


def moe_sites(cfg):
    """The MoE sites of one decode step of ``cfg`` (B = 4 token rows in
    one global dispatch group, capacity factor 2.0): the router on the
    fp32 K1 (fp32 x and weights on every backend), and the three expert
    banks on K2 with ``cap`` capacity rows per expert.  A bank of 128
    experts is hundreds of MB, past the 50 MB L2, so two copies rotate."""
    d, m, L = cfg.d_model, cfg.moe, cfg.n_layers
    E, ff = m.num_experts, m.expert_d_ff or cfg.d_ff
    cap = int(max(1, round(BATCH * m.top_k * 2.0 / E)))
    bank = dict(copies=2, cell=cfg.name)
    return [
        Site("moe.router", "arrayflex_gemm", (BATCH, d, E), L,
             cell=cfg.name, time_dtype=torch.float32),
        Site("moe.wi_gate", "arrayflex_expert_gemm", (E, cap, d, ff), L,
             **bank),
        Site("moe.wi_up", "arrayflex_expert_gemm", (E, cap, d, ff), L,
             **bank),
        Site("moe.wo", "arrayflex_expert_gemm", (E, cap, ff, d), L, **bank),
    ]


def quant_sites(cfg, rows: int, form: str, max_seq: int = MAX_SEQ):
    """The sites whose kernel form changes on a quantizing backend: every
    weight GEMM on int8 codes, and under W8A8 attn.qk on the expert
    kernel's W8A8 form (attn.pv, and attn.qk under W8, stay on the float
    expert kernel checked with the arrayflex sites)."""
    base = main_path_sites(cfg, rows, max_seq)
    return [dataclasses.replace(s, form=form) for s in base
            if s.kernel == "arrayflex_gemm"
            or (form == "w8a8" and s.name == "attn.qk")]


# Epilogue forms the main path does not use, checked once each so every
# flag of the kernel is exercised (gelu, bias2, bias without norm scale).
EXTRA_FLAGS = [
    ("extra.gelu+bias", dict(bias=True, activation="gelu")),
    ("extra.dual+bias2", dict(dual=True, bias=True, bias2=True,
                              activation="silu", residual=True)),
]


def _operands(site: Site, dt, gen, copies: int):
    """Random operands of one site: per-copy weights, shared activations."""
    def rnd(*shape, dtype=dt, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen,
                                    device="cuda")).to(dtype)
    f = site.flags
    if site.kernel == "arrayflex_expert_gemm":
        E, T, K, N = site.shape
        x = rnd(E, T, K)
        out = torch.float32 if f.get("out_f32") else None
        if site.name.startswith("moe."):    # expert banks
            ws = [rnd(E, K, N, scale=K ** -0.5) for _ in range(copies)]
            if site.form == "float":
                return x, [dict(w=w) for w in ws]
            qs = [substrate._quantize(w) for w in ws]
            return x, [dict(w=q, w_scale=s, act_quant=site.form == "w8a8")
                       for q, s in qs]
        if site.form == "w8a8":         # K^T from the bf16 cache, quantized
            qs = [substrate._quantize(rnd(E, K, N, dtype=torch.bfloat16),
                                      compiled=True)
                  for _ in range(copies)]
            return x, [dict(w=q, w_scale=s, act_quant=True, out_dtype=out)
                       for q, s in qs]
        ws = [rnd(E, K, N, dtype=torch.bfloat16) if dt == torch.float32
              and site.name == "attn.qk" else rnd(E, K, N)
              for _ in range(copies)]
        return x, [dict(w=w, out_dtype=out) for w in ws]
    M, K, N = site.shape
    x = rnd(M, K, scale=1.0)
    calls = []

    def weight(name):
        w = rnd(K, N, scale=K ** -0.5)
        if site.form == "float":
            return {name: w}
        q, s = substrate._quantize(w)
        return {name: q, f"{name}_scale": s}

    for _ in range(copies):
        kw = weight("w")
        if site.form == "w8a8":
            kw["act_quant"] = True
        if f.get("dual"):
            kw.update(weight("w2"))
        if f.get("bias"):
            kw["bias"] = rnd(N, dtype=torch.float32)
        if f.get("bias2"):
            kw["bias2"] = rnd(N, dtype=torch.float32)
        if f.get("norm_scale"):
            kw["norm_scale"] = 1.0 + 0.1 * rnd(K, dtype=torch.float32)
        if f.get("residual"):
            kw["residual"] = rnd(M, N)
        if f.get("activation"):
            kw["activation"] = f["activation"]
        if f.get("out_f32"):
            kw["out_dtype"] = torch.float32
        calls.append(kw)
    return x, calls


def _kernel_fns(site: Site):
    if site.kernel == "arrayflex_gemm":
        return ag.arrayflex_gemm, ag.arrayflex_gemm_plain
    return ag.arrayflex_expert_gemm, ag.arrayflex_expert_gemm_plain


def _library_call(site: Site, x, kw):
    """One PyTorch call computing the same product (the yardstick; the
    port never calls it), or None where there is no single call:
    torch.matmul / torch.bmm, the dual pair as one matmul against the
    concatenated weights; W8 ``torch.matmul(x, codes.to(x.dtype))``; the
    W8A8 int8 product ``torch._int_mm`` on int8 x codes where its shape
    rules allow (more than 16 rows, K and N multiples of 8; no batched
    form)."""
    w = kw["w"]
    if "w2" in kw:
        w = torch.cat([kw["w"], kw["w2"]], dim=1)
    if site.form == "w8a8":
        M, K = x.shape[-2:]
        if site.kernel == "arrayflex_expert_gemm" or not (
                M > 16 and K % 8 == 0 and w.shape[1] % 8 == 0):
            return None
        xq = torch.randint(-127, 128, (M, K), dtype=torch.int8,
                           device=x.device)
        return lambda: torch._int_mm(xq, w)
    if site.kernel == "arrayflex_expert_gemm":
        return lambda: torch.bmm(x, w.to(x.dtype))
    if site.form == "int8":
        return lambda: torch.matmul(x, w.to(x.dtype))
    return lambda: torch.matmul(x, w)


def _time_ms(fns, iters: int):
    """(device_ms, eager_ms) per call, each over ``iters`` calls that
    rotate through ``fns`` (one per weight copy) after a warm-up pass.

    device_ms: the calls captured once into a CUDA graph and replayed
    between two CUDA events — the card's time without the host's launch
    overhead.  eager_ms: the same calls launched from Python between two
    events — what an eager caller sees, host overhead included.
    """
    for fn in fns:                          # warm-up: one pass over copies
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    eager_ms = start.elapsed_time(end) / iters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fns[i % len(fns)]()
    graph.replay()                          # warm replay
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(end) / iters
    del graph
    return device_ms, eager_ms


def _ops_dtype(site: Site, dt):
    """The type whose peak rate bounds a form's products: int8 for W8A8;
    x's type otherwise (W8's int8 codes widen exactly to it)."""
    return torch.int8 if site.form == "w8a8" else dt


def _bound(site: Site, x, kw, out_dtype, dt):
    """(bound_ms, bound_by, bytes, ops): each input read once (int8 codes
    one byte each), the output written once, against the GEMM's
    operations at the peak rate of their type (the W8A8 quantizer's
    per-element work is not counted)."""
    def nbytes(t):
        return 0 if t is None or not torch.is_tensor(t) else \
            t.numel() * t.element_size()
    ins = nbytes(x) + sum(nbytes(v) for v in kw.values())
    if site.kernel == "arrayflex_expert_gemm":
        E, T, K, N = site.shape
        outs, ops_ = E * T * N, 2 * E * T * K * N
    else:
        M, K, N = site.shape
        outs = M * N
        ops_ = 2 * M * N * K * (2 if "w2" in kw else 1)
    byts = ins + outs * torch.empty((), dtype=out_dtype).element_size()
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ / PEAK_OPS_PER_S[_ops_dtype(site, dt)] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", byts, ops_)


def check_site(site: Site, dt, gen, k: int, tol_fn=None) -> float:
    """Kernel vs plain version at one k; returns the max abs error and
    raises beyond the stated tolerance."""
    fn, plain = _kernel_fns(site)
    x, calls = _operands(site, dt, gen, 1)
    kw = dict(calls[0])
    w = kw.pop("w")
    got = fn(x, w, k_collapse=k, **kw)
    want = plain(x, w, k_collapse=k, **kw)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    tol = (tol_fn(dt, scale) if tol_fn is not None
           else kernel_tol(site, dt, scale))
    SITE_CHECKS.append(dict(cell=site.cell, site=site.name,
                            shape=list(site.shape), form=site.form,
                            dtype=str(dt).split(".")[-1], k=k,
                            max_abs_err=err, scale=scale, tol=tol))
    flip = (dt == torch.bfloat16 and site.form == "float"
            and err == step_tol(dt, scale) and got.shape == want.shape)
    if not (err <= tol) and flip:
        UNLISTED_FLIPS.append((site.cell, site.name, tuple(site.shape), k,
                               err, scale))
        log(f"  UNLISTED FLIP {site.cell} {site.name} {site.shape} k={k}: "
            f"err {err} = one bf16 step at scale {scale} (fails the run at "
            f"its end)")
    elif not (err <= tol) or got.shape != want.shape:
        raise AssertionError(
            f"{site.name} {site.shape} {dt} k={k}: max abs err {err} > "
            f"tol {tol} (scale {scale})")
    return err


def planned_k(site: Site) -> int:
    """The k_collapse the substrate plans for ``site`` on the backend its
    form runs under, with the site's epilogue."""
    backend = FORM_BACKEND[site.form]
    if site.kernel == "arrayflex_expert_gemm":
        E, T, K, N = site.shape
        return substrate.plan_gemm(N, K, T, backend).k
    M, K, N = site.shape
    f = site.flags
    ep = substrate.Epilogue(
        kind="swiglu" if f.get("dual") else f.get("activation", "none"),
        bias=bool(f.get("bias")), bias2=bool(f.get("bias2")),
        residual=bool(f.get("residual")),
        norm_scale=bool(f.get("norm_scale")))
    return substrate.plan_gemm(N, K, M, backend, ep).k


def time_site(site: Site, gen, iters: int):
    """Kernel, plain and library times (ms per launch) in the main path's
    dtype at this site (bf16; fp32 for the MoE router), at the k the
    substrate plans for this site."""
    dt = site.time_dtype
    fn, plain = _kernel_fns(site)
    x, calls = _operands(site, dt, gen, site.copies)
    k = site.k or planned_k(site)

    def bind(f_, kw):
        kw = dict(kw)
        w = kw.pop("w")
        return lambda: f_(x, w, k_collapse=k, **kw)

    ms, eager_ms = _time_ms([bind(fn, kw) for kw in calls], iters)
    tile = (w8a8_tile_time(site, x, calls, k, iters)
            if site.form == "w8a8" and site_rows(site)[0] > 16 else {})
    plain_ms, plain_eager_ms = _time_ms([bind(plain, kw) for kw in calls],
                                        iters)
    libs = [_library_call(site, x, kw) for kw in calls]
    lib_ms, lib_eager_ms = (_time_ms(libs, iters) if libs[0] is not None
                            else (None, None))
    out_dtype = calls[0].get("out_dtype") or dt
    bound_ms, bound_by, byts, ops_ = _bound(site, x, calls[0], out_dtype, dt)
    return dict(k=k, dtype=str(dt).split(".")[-1], ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms,
                eager_ms=eager_ms, plain_eager_ms=plain_eager_ms,
                library_eager_ms=lib_eager_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes=byts, ops=ops_,
                **tile)


def _us(ms):
    return "    none" if ms is None else f"{ms * 1e3:8.1f}"


def w8a8_tile(site: Site, k: int) -> dict:
    """The int8 tensor-core tile that runs a W8A8 site above 16 rows, from
    the C entries: its width (columns a block), dynamic shared memory and
    the scratch its quantize pass fills, at the reference's quantization
    tile for k."""
    rows, N, batch = site_rows(site)
    K = site.shape[-2]
    bm, qkk = ag.quant_tiles(rows, K, k)
    dual = int(bool(site.flags.get("dual")))
    lib = ag._lib()
    return dict(quant_tile=(bm, qkk),
                tile_cols=lib.af_w8a8_tc_cols(rows, N, dual, batch),
                tile_smem=lib.af_w8a8_tc_smem(rows, N, K, bm, qkk, dual,
                                              batch),
                scratch_bytes=lib.af_w8a8_scratch_bytes(rows, K, bm, qkk,
                                                        batch))


def w8a8_tile_time(site: Site, x, calls, k: int, iters: int) -> dict:
    """The quantize pass alone (``ag.w8a8_quantize``: the launch's first
    kernel, same x, g and k) at a W8A8 site above 16 rows: its device time
    (``quantize_ms``; the whole launch's is ``ms``), with the tile's shape
    (:func:`w8a8_tile`)."""
    fns = [lambda g=kw.get("norm_scale"): ag.w8a8_quantize(
        x, norm_scale=g, k_collapse=k) for kw in calls]
    q_ms, _ = _time_ms(fns, iters)
    return dict(quantize_ms=q_ms, **w8a8_tile(site, k))


def ssm_sites(cfg, rows: int, form: str = "float"):
    """The K1 sites of the SSM cell ``cfg`` at ``rows`` token rows (B at
    decode; S of the full-sequence prefill at B = 1, where the tied
    unembed takes every row, as ``lm.prefill`` computes every position's
    logits before it keeps the last): the mamba mixer's four GEMMs per
    layer, none with a fused prologue or epilogue (the mixer's rmsnorm
    runs before mamba.z / xbc / dt, the residual join after mamba.out),
    and the unembed.  mamba.dt has N = H = 32 columns.  At the prefill two
    weight copies rotate: the products, not the weight bytes, set the
    time."""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.padded_vocab
    ssm = cfg.ssm
    d_in = ssm.expand * d
    H = d_in // ssm.head_dim
    ch = d_in + 2 * ssm.n_groups * ssm.d_state
    kw = dict(cell=cfg.name, form=form)
    if rows > BATCH:
        kw["copies"] = 2
    return [
        Site("mamba.z", "arrayflex_gemm", (rows, d, d_in), L, **kw),
        Site("mamba.xbc", "arrayflex_gemm", (rows, d, ch), L, **kw),
        Site("mamba.dt", "arrayflex_gemm", (rows, d, H), L, **kw),
        Site("mamba.out", "arrayflex_gemm", (rows, d_in, d), L, **kw),
        Site("unembed", "arrayflex_gemm", (rows, d, V), 1,
             dict(out_f32=True) if cfg.tie_embeddings else {}, copies=1,
             cell=cfg.name, form=form),
    ]


def kernel_phase(cfg, moe_cfg, chunk: int, form: str = "float",
                 ssm_cfg=None):
    """Check and time every site of ``form`` (the float sites of the
    arrayflex path, or the int8 sites of a quantizing backend's path) on
    the dense model ``cfg`` at decode and at the prefill chunk, on the
    MoE model ``moe_cfg`` at decode (its prefill runs decode steps), and
    on the SSM model ``ssm_cfg`` at decode and at its full-sequence
    prefill (phase ``prefill S=SSM_FWD_SEQ``)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    # the K1 sites' fp32 timings draw from a generator of their own, so the
    # operands every check draws from ``gen`` do not depend on them (a
    # float check's KERNEL_TOL is tighter than one bf16 step just below a
    # power of two: other operands can flip a site, TC_FLIP_SITES)
    gen_k1_fp32 = torch.Generator(device="cuda").manual_seed(1)
    results, max_err = [], {}
    plan = [(phase, main_path_sites(cfg, rows) if form == "float"
             else quant_sites(cfg, rows, form))
            for phase, rows in (("decode", BATCH), ("prefill", BATCH * chunk))]
    moe_path = (main_path_sites(moe_cfg, BATCH, MOE_MAX_SEQ)
                if form == "float"
                else quant_sites(moe_cfg, BATCH, form, MOE_MAX_SEQ))
    plan.append(("decode", moe_path + [
        dataclasses.replace(s, form=form) for s in moe_sites(moe_cfg)
        if form == "float" or s.kernel == "arrayflex_expert_gemm"]))
    if ssm_cfg is not None:
        plan += [("decode", ssm_sites(ssm_cfg, BATCH, form)),
                 (f"prefill S={SSM_FWD_SEQ}",
                  ssm_sites(ssm_cfg, SSM_FWD_SEQ, form))]
    for phase, sites in plan:
        for site in sites:
            if (form == "int8" and site.kernel == "arrayflex_expert_gemm"
                    and site.shape[1] <= 16):
                check_bank_width(site)
            if form == "w8a8" and phase == "decode":
                check_w8a8_width(site)
            errs = {}
            for dt in (torch.bfloat16, torch.float32):
                for k in (1, 2, 4):
                    errs[f"{dt}".split(".")[-1] + f"/k{k}"] = check_site(
                        site, dt, gen, k)
            bf16_err = max(v for key, v in errs.items()
                           if key.startswith("bfloat16"))
            if phase == "decode":
                for dt in (torch.bfloat16, torch.float32):
                    name = site.kernel_key(dt)
                    err = max(v for key, v in errs.items()
                              if key.startswith(str(dt).split(".")[-1]))
                    # the FFMA kernels of fp32 x are booked with their
                    # fp32 checks, every other kernel with its bf16 ones
                    # (the path's type)
                    if dt == torch.bfloat16 or name in FFMA_FP32:
                        max_err[name] = max(max_err.get(name, 0.0), err)
            iters = 10 if site.name == "unembed" else 2 * site.copies
            timed = [(site, gen)]
            if (phase == "decode" and site.time_dtype != torch.float32
                    and site.kernel_key(torch.float32) in FFMA_FP32):
                # the FFMA kernels run only on the fp32 path: time them
                # there too
                timed.append((dataclasses.replace(
                    site, time_dtype=torch.float32),
                    gen if site.kernel == "arrayflex_expert_gemm"
                    else gen_k1_fp32))
            for ts, ts_gen in timed:
                t = time_site(ts, ts_gen, iters)
                row = dict(phase=phase, cell=ts.cell, site=ts.name,
                           kernel=ts.kernel, form=ts.form,
                           launch_name=ts.kernel_key(ts.time_dtype),
                           shape=ts.shape,
                           per_step=ts.per_step, max_abs_err=errs, **t)
                results.append(row)
                log(f"  {phase:7s} {ts.form:5s} {ts.name:22s} "
                    f"{str(ts.shape):26s} {t['dtype']:8s} k={t['k']} kernel "
                    f"{_us(t['ms'])} us  plain {_us(t['plain_ms'])} us  "
                    f"library {_us(t['library_ms'])} us  bound "
                    f"{t['bound_ms']*1e3:7.2f} us ({t['bound_by']})  eager "
                    f"kernel/plain/library {_us(t['eager_ms'])}/"
                    f"{_us(t['plain_eager_ms'])}/"
                    f"{_us(t['library_eager_ms'])} us  "
                    f"bf16 err {bf16_err:.3g}")
                if "quantize_ms" in t:
                    log(f"          quantize pass {_us(t['quantize_ms'])} us "
                        f"of the kernel's {_us(t['ms'])} us; int8 "
                        f"tensor-core tile {t['tile_cols']} columns a "
                        f"block, {t['tile_smem']} B shared memory")
    for name, flags in EXTRA_FLAGS:
        site = Site(name, "arrayflex_gemm", (BATCH, cfg.d_model, cfg.d_ff),
                    0, flags, form=form)
        for dt in (torch.bfloat16, torch.float32):
            for k in (1, 2, 4):
                check_site(site, dt, gen, k)
        log(f"  checked {form} {name} in bf16/fp32 at k=1,2,4")
    return results, max_err


def check_bank_width(site: Site) -> int:
    """An int8-only MoE bank at T <= 16 runs the narrow tile: its width,
    from the C entry, must be the written rule's (:func:`narrow_int8_cols`,
    the grid counted as blocks x experts)."""
    E, T, K, N = site.shape
    got = ag._lib().af_narrow_cols(T, N, 2, E)
    want = narrow_int8_cols(T, N, E)
    if got != want:
        raise AssertionError(f"{site.name} {site.shape}: narrow tile width "
                             f"{got}, the rule gives {want}")
    return got


def site_rows(site: Site):
    """(rows, N, batch) of a site: K1's M, or K2's T of E experts."""
    if site.kernel == "arrayflex_expert_gemm":
        E, T, K, N = site.shape
        return T, N, E
    M, K, N = site.shape
    return M, N, 1


def check_w8a8_width(site: Site) -> int:
    """A W8A8 decode site (K1 at M <= 16, K2 at T <= 16) runs the W8A8
    narrow tile: its width, from the C entry, must be the written int8
    rule's (:func:`narrow_int8_cols`, the grid counted as blocks x
    experts)."""
    rows, N, batch = site_rows(site)
    got = ag._lib().af_w8a8_cols(rows, N, batch)
    want = narrow_int8_cols(rows, N, batch)
    if got != want:
        raise AssertionError(f"{site.name} {site.shape}: W8A8 narrow tile "
                             f"width {got}, the rule gives {want}")
    return got


def kt_quantize_time(cfg):
    """Device time of the plain-torch K^T quantize (``substrate._quantize``
    per (batch, key column)) that attn.qk runs before its W8A8 launch,
    once per layer and step, at the smoke run's cache shape."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    E, hd = BATCH * cfg.n_kv_heads, cfg.resolved_head_dim
    kts = [torch.randn(E, hd, MAX_SEQ, generator=gen,
                       device="cuda").to(torch.bfloat16) for _ in range(24)]
    ms, eager_ms = _time_ms([lambda t=t: substrate._quantize(t)
                             for t in kts], 48)
    out = dict(shape=(E, hd, MAX_SEQ), ms=ms, eager_ms=eager_ms,
               per_step=cfg.n_layers, ms_per_step=ms * cfg.n_layers)
    log(f"  attn.qk K^T quantize (plain torch) {out['shape']}: "
        f"{ms * 1e3:.1f} us device, {eager_ms * 1e3:.1f} us eager per call; "
        f"{out['ms_per_step']:.3f} ms device per step ({cfg.n_layers} calls)")
    return out


# ---------------------------------------------------------------------------
# phase 4: flash attention (K3) through ops.attention

# K3 is held to its plain version within step_tol.  bf16: the kernel takes
# each planner chunk's row max in a first pass over the chunk (choice (a) in
# csrc/flash_attention.cu), so p is rounded to bf16 against the same max
# as in the plain version and the reference; what remains is fp32 summation
# order over up to 4097 columns and expf's last bit, then one rounding of
# the output to bf16 (one bf16 step at the largest |value|).  fp32: p is
# not rounded, so the kernel takes one pass with the running max rescaled
# per 64-column sub-tile; it differs from the chunk-max form by fp32
# rounding only (1e-5 of the largest |value|).
#
# (name, BH, S, T, D, causal, window, dtype).  BH folds batch x heads with
# the KV heads repeated: qwen2-0.5b's 14 query heads (x4 requests at the
# smoke run's prefill chunk), qwen3-moe-30b-a3b's 32, B = 1 at long prefill.
# T = 4097 is two planner chunks, the second holding one valid column; the
# last case's rows 319.. see no column (non-causal, window 64, S > T).
K3_CASES = [
    ("qwen2 prefill chunk (yardstick)", 56, 256, 256, 64, True, 0,
     torch.bfloat16),
    ("qwen2 long prefill", 14, 4096, 4096, 64, True, 0, torch.bfloat16),
    ("qwen2 long prefill fp32", 14, 4096, 4096, 64, True, 0, torch.float32),
    ("qwen3-moe long prefill", 32, 4096, 4096, 128, True, 0,
     torch.bfloat16),
    ("ragged non-causal", 14, 128, 4097, 64, False, 0, torch.bfloat16),
    ("window 512", 14, 4096, 4096, 64, True, 512, torch.bfloat16),
    ("fully masked rows", 14, 512, 256, 64, False, 64, torch.bfloat16),
    ("ragged non-causal fp32", 14, 128, 4097, 64, False, 0, torch.float32),
    ("window 512 fp32", 14, 4096, 4096, 64, True, 512, torch.float32),
    ("fully masked rows fp32", 14, 512, 256, 64, False, 64, torch.float32),
]


def _visible_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """(query row, key column) pairs the masks leave, per head."""
    rows = np.arange(S)
    hi = np.minimum(T, rows + 1) if causal else np.full(S, T)
    lo = np.maximum(0, rows - window + 1) if window else np.zeros(S, int)
    return int(np.maximum(hi - lo, 0).sum())


def k3_bound(BH, S, T, D, causal, window, dt):
    """(bound_ms, bound_by, bytes, ops): q, k, v read and o written once;
    the QK^T and PV multiply-adds of the visible pairs at the peak rate of
    the operands' type."""
    size = torch.empty((), dtype=dt).element_size()
    byts = (2 * BH * S * D + 2 * BH * T * D) * size
    ops_ = 4 * BH * D * _visible_pairs(S, T, causal, window)
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ / PEAK_OPS_PER_S[dt] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", byts, ops_)


def k3_phase():
    """Drive ``ops.attention`` once per case (the K3 path: the counter set
    to 0 just before and read just after), hold each output against the
    plain version on the same inputs, then time the kernel, the plain
    version and ``scaled_dot_product_attention`` (not on the case with
    fully masked rows, where it returns NaN)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    inputs = []
    for name, BH, S, T, D, causal, window, dt in K3_CASES:
        q, k, v = (torch.randn(BH, n, D, generator=gen, device="cuda").to(dt)
                   for n in (S, T, T))
        inputs.append((q, k, v))
    torch.cuda.synchronize()
    fa.reset_launches()                     # counts: 0 just before the run
    outs = [ops.attention(q, k, v, causal=case[5], window=case[6])
            for case, (q, k, v) in zip(K3_CASES, inputs)]
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)            # read just after the run
    n_bf16 = sum(case[-1] == torch.bfloat16 for case in K3_CASES)
    if launches != {"flash_attention": len(K3_CASES),
                    "flash_attention_tc": n_bf16}:
        raise AssertionError(f"K3 launches {launches}: want one per "
                             f"ops.attention call ({len(K3_CASES)}), every "
                             f"bf16 one ({n_bf16}) on the tensor-core kernel")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    results = []
    for case, (q, k, v), got in zip(K3_CASES, inputs, outs):
        name, BH, S, T, D, causal, window, dt = case
        kc = planner.attention_plan(S, T)
        k3_kernel = ("flash_attention_tc"
                     if fa.attention_kernel(dt) == "flash_attention_tc"
                     else "flash_attention")
        n_split = (fa.kv_splits(BH, S, T, kc, n_sm)
                   if k3_kernel == "flash_attention_tc" else 1)
        want = fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window, kv_chunk=kc)
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        tol = step_tol(dt, scale)
        dead = want.float().abs().amax(dim=-1) == 0
        n_dead = int(dead.sum().item())
        if (not err <= tol or got.shape != want.shape
                or not bool(torch.isfinite(got).all())
                or not torch.equal(got[dead], torch.zeros_like(got[dead]))):
            raise AssertionError(f"K3 {name}: max abs err {err} > tol {tol} "
                                 f"(scale {scale}), or a non-finite or "
                                 f"non-zero fully masked row")
        del want
        iters = 20 if S * T <= 256 * 256 else 3

        def kernel(q=q, k=k, v=v, causal=causal, window=window):
            return ops.attention(q, k, v, causal=causal, window=window)

        def plain(q=q, k=k, v=v, causal=causal, window=window, kc=kc):
            return fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window, kv_chunk=kc)

        ms, eager_ms = _time_ms([kernel], iters)
        plain_ms, _ = _time_ms([plain], min(iters, 2))
        lib_ms = None
        if not n_dead:
            q4, k4, v4 = (t.unsqueeze(0) for t in (q, k, v))
            mask = None
            if window:
                r = torch.arange(S, device="cuda")[:, None]
                c = torch.arange(T, device="cuda")[None, :]
                mask = c > r - window
                if causal:
                    mask = mask & (c <= r)
            lib_ms, _ = _time_ms([lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask,
                is_causal=causal and mask is None)], iters)
        _free()
        bound_ms, bound_by, byts, ops_ = k3_bound(BH, S, T, D, causal,
                                                  window, dt)
        row = dict(case=name, BH=BH, S=S, T=T, D=D, causal=causal,
                   window=window, dtype=str(dt).split(".")[-1], kv_chunk=kc,
                   kernel=k3_kernel, kv_splits=n_split,
                   max_abs_err=err, tol=tol, fully_masked_rows=n_dead,
                   ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                   bytes=byts, ops=ops_)
        results.append(row)
        log(f"  {name:32s} BH {BH:2d} S {S:4d} T {T:4d} D {D:3d} "
            f"{row['dtype']:8s} chunk {kc:4d} splits {n_split:2d} "
            f"{k3_kernel}: kernel {_us(ms)} us  plain "
            f"{_us(plain_ms)} us  sdpa {_us(lib_ms)} us  bound "
            f"{bound_ms * 1e3:8.2f} us ({bound_by}); err {err:.3g} (tol "
            f"{tol:.3g}){f'; {n_dead} fully masked rows' if n_dead else ''}")
    del inputs, outs
    _free()
    # per kernel: the FFMA kernel's launches are those not on tensor cores
    return results, {"flash_attention": launches["flash_attention"]
                     - launches["flash_attention_tc"],
                     "flash_attention_tc": launches["flash_attention_tc"]}


# ---------------------------------------------------------------------------
# phase 5: serving

ATTN_SITES = ("attn.wq", "attn.wk", "attn.wv", "attn.qk", "attn.pv",
              "attn.wo")
MLP_SITES = ("mlp.wi_gate+mlp.wi_up", "mlp.wo")
MOE_SITES = ("moe.router", "moe.wi_gate", "moe.wi_up", "moe.wo")
# a mamba mixer's dispatches, in the order nn.mamba runs them
MAMBA_SITES = ("mamba.z", "mamba.xbc", "mamba.dt", "mamba.out")
# a cross-attending sub-layer's cross-attention at decode (the context's
# K/V read from the cache), and over a full sequence (K/V projected from
# the context, both at the one xattn.kv label)
CROSS_DECODE_SITES = ("xattn.wq", "attn.qk", "attn.pv", "xattn.wo")
CROSS_FULL_SITES = ("xattn.wq", "xattn.kv", "xattn.kv", "attn.qk",
                    "attn.pv", "xattn.wo")


def step_sites(cfg, full: bool = False):
    """One engine step's substrate dispatches, in order: per layer its
    mixer's (:func:`lm.sublayer_kind`: the attention's projections and
    products, or the mamba mixer's four GEMMs), its cross-attention's
    where it cross-attends (``full``: a full sequence's, which projects
    the context's K/V), then its MLP's (the dense MLP's two GEMMs, the MoE
    router and three expert banks, or none); the unembed last."""
    seq = []
    for _ in range(lm.n_super(cfg)):
        for i in range(lm.period(cfg)):
            kind = lm.sublayer_kind(cfg, i)
            seq += ATTN_SITES if kind["mixer"] == "attn" else MAMBA_SITES
            if kind["cross"]:
                seq += CROSS_FULL_SITES if full else CROSS_DECODE_SITES
            seq += {"dense": MLP_SITES, "moe": MOE_SITES,
                    None: ()}[kind["mlp"]]
    return seq + ["unembed"]


def site_launches(cfg, site: str) -> dict:
    """The kernel launches one dispatch of ``site`` makes on ``cfg``'s
    backend, by counter: the attention projections, the mamba mixer's
    GEMMs, a dense MLP's GEMMs and the unembed on the backend's K1 form,
    an MoE router on the float
    K1, the expert banks on the backend's K2 form, attn.qk on K2 (its
    W8A8 form under W8A8) and attn.pv on the float K2.  Every bf16 K1
    launch, float or W8, and every float K2 launch in bf16 also counts on
    its tensor-core kernel (the fp32 router stays on the FFMA kernel)."""
    be = cfg.gemm_backend
    suffix = {"arrayflex": "", "arrayflex_int8": "_int8",
              "arrayflex_w8a8": "_w8a8"}[be]
    bf16 = cfg.compute_dtype == "bfloat16"
    if site == "moe.router":
        return {"arrayflex_gemm": 1}
    if site in ("attn.qk", "attn.pv") or site in MOE_SITES:
        name = ("arrayflex_expert_gemm_w8a8"
                if site == "attn.qk" and be == "arrayflex_w8a8"
                else "arrayflex_expert_gemm" + suffix
                if site in MOE_SITES else "arrayflex_expert_gemm")
        tc = bf16 and name == "arrayflex_expert_gemm"
    else:
        name = "arrayflex_gemm" + suffix
        tc = bf16 and be != "arrayflex_w8a8"
    return {name: 1, **({name + "_tc": 1} if tc else {})}


def expected_launches(cfg, steps: int):
    """Kernel launches of ``steps`` engine steps of ``cfg`` on its backend,
    per counter: each step dispatches :func:`step_sites`, each dispatch
    launching :func:`site_launches`."""
    want = {name: 0 for name in ag.LAUNCHES}
    for site in step_sites(cfg):
        for name, n in site_launches(cfg, site).items():
            want[name] += n * steps
    return want


def retried_launches(cfg, stats: dict, chaos_log,
                     per_dispatch: bool = False) -> dict:
    """Kernel launches of a serving run with retries: the per-step counts
    times every dispatch that ran in full — the prefill and decode steps,
    and each decode step a non-finite retry ran again — plus, for each
    injected GEMM fault of ``chaos_log``, the launches its attempt made
    before the faulted site: the sites that precede the site label's
    first dispatch of the step (an attempt draws each label once a
    sub-layer position, at its first dispatch there: for a model of
    period 1, and for a fault at a label's first position, that is the
    label's first dispatch), the faulted one launching nothing.  With
    ``per_dispatch`` every dispatch of an attempt drew
    (:func:`every_dispatch_draws`) and each fault was in the run's first
    attempt, so its draw index is its dispatch's index in the step."""
    steps = (stats["prefill_dispatches"] + stats["decode_dispatches"]
             + stats["sample_retries"])
    want = expected_launches(cfg, steps)
    seq = step_sites(cfg)
    for point, n, site in chaos_log:
        if point != "substrate.dispatch":
            continue
        if per_dispatch and not (n < len(seq) and seq[n] == site):
            raise AssertionError(f"fault at draw {n} ({site}) is not "
                                 f"dispatch {n} of the first step")
        for before in seq[:n if per_dispatch else seq.index(site)]:
            for name, n in site_launches(cfg, before).items():
                want[name] += n
    return want


# the tensor-core kernels' launch counters, each a subset of the form's
# counter named without "_tc"
TC_COUNTERS = ("arrayflex_gemm_tc", "arrayflex_gemm_int8_tc",
               "arrayflex_expert_gemm_tc")


def check_fp32_w8_launches(what: str, launches: dict) -> None:
    """An fp32 ``arrayflex_int8`` run: its W8 K1 launches all on the FFMA
    kernel (at least one), none on a tensor-core kernel."""
    if not launches["arrayflex_gemm_int8"] or any(
            launches[name] for name in TC_COUNTERS):
        raise AssertionError(f"{what}: kernel launches {launches}: want W8 "
                             f"K1 launches, every one on the FFMA kernel, "
                             f"and none on a tensor-core kernel")


def check_launches(what: str, launches: dict, want: dict) -> None:
    """Every count as planned; in particular, every bf16 K1 and K2 launch
    of the run on the tensor-core kernels (``arrayflex_gemm_tc``,
    ``arrayflex_gemm_int8_tc``, ``arrayflex_expert_gemm_tc``) and every
    fp32 one on FFMA."""
    for tc in TC_COUNTERS:
        if launches.get(tc) != want.get(tc):
            raise AssertionError(
                f"{what}: {launches.get(tc)} launches counted in {tc}, want "
                f"{want.get(tc)} (every bf16 launch of its form, no fp32 "
                f"one)")
    if launches != want:
        raise AssertionError(f"{what}: kernel launches {launches} != "
                             f"expected {want}")


RETRY_COUNTERS = ("sample_retries", "kernel_fault_retries", "watchdog_fired")


def check_clean(what: str, engine, reqs) -> None:
    """A chaos-free run: every request ended ``ok`` and nothing was
    retried or broken by the watchdog — a kernel that emits NaN fails the
    run here (the engine turns a non-finite logit row into a typed
    failure, not a raise)."""
    bad = {r.rid: (r.outcome, r.error) for r in reqs if r.outcome != "ok"}
    counts = {k: engine.stats[k] for k in RETRY_COUNTERS}
    if bad or any(counts.values()):
        raise AssertionError(f"{what}: requests not ok {bad}, {counts}")


def serving_phase(cfg, params, prompt_lens=PROMPT_LENS, max_new=MAX_NEW,
                  max_seq=MAX_SEQ, record=False):
    """Serve ``prompt_lens`` greedy requests on ``cfg``'s backend after a
    warm-up engine, holding the run's launches to the per-step plan; with
    ``record`` the result also carries ``sites``: the K1 / K2 launches of
    one decode step and, in batched prefill, of one prefill chunk of every
    row, on the engine's own tree and cache (:func:`recorded_sites`)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in prompt_lens]
    sc = ServeConfig(max_batch=BATCH, max_seq=max_seq, seed=0)
    # warm-up engine: first-call costs (allocator, cuBLAS handles) are not
    # the serving numbers
    warm = ServingEngine(cfg, params, sc)
    warm_req = Request(prompt=prompts[0][:8], max_new_tokens=2)
    warm.submit(warm_req)
    warm.run_to_completion()
    check_clean(f"warm-up {cfg.name} on {cfg.gemm_backend}", warm,
                [warm_req])
    del warm
    engine = ServingEngine(cfg, params, sc)
    reqs = [Request(prompt=p, max_new_tokens=max_new, rid=i)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    substrate.DISPATCH_COUNTS.clear()
    ag.reset_launches()                     # counts: 0 just before the run
    fa.reset_launches()
    t0 = time.perf_counter()
    ticks = engine.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ag.LAUNCHES)            # read just after the run
    if fa.LAUNCHES["flash_attention"]:
        raise AssertionError("serving launched flash attention (K3): it is "
                             "not on the model path")
    dispatches = dict(substrate.DISPATCH_COUNTS)
    st = engine.stats
    steps = st["prefill_dispatches"] + st["decode_dispatches"]
    L = cfg.n_layers
    want = expected_launches(cfg, steps)
    for r in reqs:
        if not r.done or len(r.out_tokens) != max_new:
            raise AssertionError(f"request {r.rid}: done={r.done}, "
                                 f"{len(r.out_tokens)} of {max_new} tokens")
    check_clean(f"serving {cfg.name} on {cfg.gemm_backend}", engine, reqs)
    check_launches(f"serving {cfg.name} on {cfg.gemm_backend} ({steps} "
                   f"steps of {L} layers)", launches, want)
    ttft = [r.ttft_s for r in reqs]
    out = dict(
        model=cfg.name, n_layers=L, param_dtype=cfg.param_dtype,
        requests=len(reqs), prompt_lens=list(prompt_lens), max_new=max_new,
        ticks=ticks, wall_s=wall,
        tokens_per_s=sum(len(r.out_tokens) for r in reqs) / wall,
        prefill_mode=engine.prefill_mode,
        prefill_tokens=st["prefill_tokens"],
        prefill_time_s=st["prefill_time_s"],
        prefill_dispatches=st["prefill_dispatches"],
        decode_tokens=st["decode_tokens"], decode_time_s=st["decode_time_s"],
        decode_dispatches=st["decode_dispatches"],
        decode_step_ms=1e3 * st["decode_time_s"] / st["decode_dispatches"],
        mean_ttft_ms=1e3 * sum(ttft) / len(ttft),
        ttft_ms=[1e3 * t for t in ttft],
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
        launches=launches, dispatch_counts=dispatches,
        prefill_chunk=engine.prefill_chunk,
        kv_cache_bytes=engine.kv_cache_bytes(),
        streams=[r.out_tokens for r in reqs])
    log(f"  {cfg.name} x{L} on {cfg.gemm_backend}: "
        f"{out['tokens_per_s']:.1f} tok/s over {wall:.3f} s, {ticks} "
        f"ticks; prefill[{engine.prefill_mode}] {st['prefill_tokens']} tok "
        f"in {st['prefill_time_s']:.4f} s ({st['prefill_dispatches']} "
        f"dispatches, chunk {engine.prefill_chunk}); decode "
        f"{st['decode_tokens']} tok in {st['decode_time_s']:.4f} s "
        f"({out['decode_step_ms']:.2f} ms/step); mean TTFT "
        f"{out['mean_ttft_ms']:.1f} ms; max memory allocated "
        f"{out['max_memory_allocated_bytes'] / 2**30:.2f} GiB")
    log(f"  launches {({k: v for k, v in launches.items() if v})} "
        f"== per-step counts x {steps} steps")
    out["profile"] = profile_decode_step(cfg, engine, out["decode_step_ms"],
                                         max_seq)
    if record:
        out["sites"] = record_step_sites(cfg, engine, max_seq)
    return out


@contextlib.contextmanager
def recorded_sites(cell: str):
    """Record the K1 / K2 launches made inside (through
    ``ops.arrayflex_matmul`` / ``ops.arrayflex_expert_matmul``, each
    labelled by the substrate dispatch that made it) as :class:`Site`
    rows, one per distinct (label, kernel, shape, form, epilogue flags, k,
    x dtype), ``per_step`` its launches inside: the shapes, flags and
    planned k the path gave each kernel.  Yields the list, filled on
    exit."""
    seen, label = {}, [""]
    record = substrate._record
    mm, emm = ops.arrayflex_matmul, ops.arrayflex_expert_matmul

    def rec(site, plan, launches=1):
        label[0] = site
        return record(site, plan, launches)

    def note(kernel, shape, x, w, kw):
        form = ("w8a8" if kw.get("act_quant") else
                "int8" if kw.get("w_scale") is not None else "float")
        flags = dict(
            bias=kw.get("bias") is not None,
            bias2=kw.get("bias2") is not None,
            dual=kw.get("w2") is not None,
            norm_scale=kw.get("norm_scale") is not None,
            residual=kw.get("residual") is not None,
            out_f32=kw.get("out_dtype") == torch.float32,
            activation=kw.get("activation", "none"))
        flags = tuple(sorted((key, v) for key, v in flags.items()
                             if v and v != "none"))
        w_bytes = w.numel() * w.element_size() * (2 if kw.get("w2")
                                                  is not None else 1)
        key = (label[0], kernel, shape, form, flags, kw["k_collapse"],
               x.dtype, w_bytes)
        seen[key] = seen.get(key, 0) + 1

    def mm_rec(x, w, **kw):
        note("arrayflex_gemm",
             (math.prod(x.shape[:-1]), x.shape[-1], w.shape[-1]), x, w, kw)
        return mm(x, w, **kw)

    def emm_rec(x, w, **kw):
        note("arrayflex_expert_gemm", (*x.shape, w.shape[-1]), x, w, kw)
        return emm(x, w, **kw)

    sites = []
    substrate._record = rec
    ops.arrayflex_matmul, ops.arrayflex_expert_matmul = mm_rec, emm_rec
    try:
        yield sites
    finally:
        substrate._record = record
        ops.arrayflex_matmul, ops.arrayflex_expert_matmul = mm, emm
    for (name, kernel, shape, form, flags, k, dt, w_bytes), n in seen.items():
        # weight copies rotate past the 50 MB L2, as the layers' do
        copies = int(min(24, max(2, -(-64 * 2 ** 20 // max(w_bytes, 1)))))
        sites.append(Site(name, kernel, shape, n, dict(flags), copies=copies,
                          form=form, cell=cell, time_dtype=dt, k=k))
    sites.sort(key=lambda st: (st.kernel, st.name, st.shape))


def record_step_sites(cfg, engine, max_seq: int):
    """The K1 / K2 sites of one decode step of ``engine`` (all BATCH rows,
    at position max_seq / 2) and, when it prefills in batches, of one
    prefill chunk of BATCH x chunk rows from position 0
    (:func:`recorded_sites`), by phase."""
    toks = torch.zeros(BATCH, dtype=torch.int64, device="cuda")
    pos = torch.full((BATCH,), max_seq // 2, dtype=torch.int64,
                     device="cuda")
    with recorded_sites(cfg.name) as sites:
        lm.decode_step(cfg, engine.params, engine.cache, toks, pos)
    out = {"decode": sites}
    if engine.prefill_mode == "batched":
        C = engine.prefill_chunk
        chunk = torch.zeros((BATCH, C), dtype=torch.int64, device="cuda")
        start = torch.zeros(BATCH, dtype=torch.int64, device="cuda")
        lens = torch.full((BATCH,), C, dtype=torch.int64, device="cuda")
        with recorded_sites(cfg.name) as sites:
            lm.prefill_step(cfg, engine.params, engine.cache, chunk, start,
                            lens)
        out[f"prefill chunk {C}"] = sites
    torch.cuda.synchronize()
    return out


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def moe_serving_phase(moe_cfg):
    """Full-width qwen3-moe-30b-a3b in bf16 parameters (never an fp32
    master): all 48 layers on arrayflex, then, with that tree freed, 24
    layers on the two int8 backends (each engine holds the bf16 tree and
    its int8 copy)."""
    out = {}
    for L, backends in ((moe_cfg.n_layers, ("arrayflex",)),
                        (MOE_QUANT_LAYERS, ("arrayflex_int8",
                                            "arrayflex_w8a8"))):
        cfg = dataclasses.replace(moe_cfg, n_layers=L)
        t0 = time.perf_counter()
        params = lm.init_params(cfg, seed=0)
        torch.cuda.synchronize()
        n_bytes = sum(t.numel() * t.element_size()
                      for t in _tensors(params))
        log(f"  {cfg.name} x{L}: {n_bytes / 1e9:.2f} GB of bf16 parameters "
            f"built in {time.perf_counter() - t0:.1f} s")
        for backend in backends:
            out[backend] = serving_phase(
                dataclasses.replace(cfg, gemm_backend=backend), params,
                MOE_PROMPT_LENS, MOE_MAX_NEW, MOE_MAX_SEQ)
            out[backend]["param_bytes"] = n_bytes
            _free()
        del params
        _free()
    return out


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)
    else:
        yield tree


def profile_device(fn, wall_ms: float, what: str):
    """Device busy time of one ``fn()`` (torch.profiler: the summed time
    of the device-side events — kernels, copies, memsets — on the one
    stream; a CPU op's own "self device time" repeats its kernels' time,
    so CPU ops are not summed) against ``wall_ms``, the host-clock time of
    the same work measured outside the profiler; ``fn`` runs once before,
    as warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    evs = [e for e in prof.key_averages()
           if e.device_type != DeviceType.CPU and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in evs) / 1e3
    top = sorted(evs, key=dev_us, reverse=True)[:6]
    out = dict(device_busy_ms=busy_ms, step_ms=wall_ms,
               idle_share=(1.0 - busy_ms / wall_ms) if busy_ms else None,
               top=[(e.key[:160], dev_us(e) / 1e3, e.count) for e in top])
    if busy_ms:
        log(f"  profiler: device busy {busy_ms:.2f} ms of a {wall_ms:.2f} "
            f"ms {what} (idle share {out['idle_share']:.2f})")
        for name, ms, n in out["top"]:
            log(f"    {ms:8.3f} ms  x{n:4d}  {name}")
    else:
        log("  profiler: no device time recorded (not measured)")
    return out


def profile_decode_step(cfg, engine, step_ms: float, max_seq: int):
    """Device busy time of one full-batch decode step against the
    engine's measured step time."""
    toks = torch.zeros(BATCH, dtype=torch.int64, device="cuda")
    pos = torch.full((BATCH,), max_seq // 2, dtype=torch.int64,
                     device="cuda")
    return profile_device(
        lambda: lm.decode_step(cfg, engine.params, engine.cache, toks, pos),
        step_ms, "decode step")


# ---------------------------------------------------------------------------
# phase 5, paged: the paged K/V pool and the radix prefix cache

# (b): more sequences than dispatch rows, each reserving one page
PAGED_SHORT_LENS = (8, 10, 12, 14, 16, 18, 20, 22)
PAGED_SHORT_NEW = 8
# (c): followers sharing a system prompt with the first request
PREFIX_SYSTEM, PREFIX_TAIL, PREFIX_REQUESTS, PREFIX_NEW = 128, 8, 8, 8
# decode steps timed alone, dense and paged in turns, per side
STEP_PAIRS = 20


def paged_pool_pages(prompt_lens, max_new: int, max_seq: int,
                     page: int) -> int:
    """Pages of a pool that reserves every request in full at once (each
    its prompt + max_new, clipped to max_seq), with the scratch page and
    at least the engine's minimum (max_seq / page + 1)."""
    need = sum(-(-min(n + max_new, max_seq) // page) for n in prompt_lens)
    return max(need, max_seq // page) + 1


def shared_prefix_prompts(vocab: int, n: int, system: int, tail: int,
                          seed: int = 0):
    """``n`` prompts: one random ``system``-token prompt, each with its own
    random ``tail``-token ending."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, system).tolist()
    return [head + rng.integers(0, vocab, tail).tolist() for _ in range(n)]


def prefill_step_launches(cfg, n_steps: int) -> int:
    """K1 and K2 launches of ``n_steps`` prefill-chunk steps (the
    tensor-core counters are subsets, not added)."""
    return sum(v for k, v in expected_launches(cfg, n_steps).items()
               if k not in TC_COUNTERS)


def profile_block_tables(batch: int, pages_per_seq: int, write_idx: int):
    """Block tables of a full-batch paged decode step that writes entry
    ``write_idx`` of every row's view: row r owns page 2 + r there, every
    other entry reads page 1 (aliased, never written), so no two rows
    write one page."""
    bt = np.ones((batch, pages_per_seq), np.int64)
    bt[:, write_idx] = 2 + np.arange(batch)
    return bt


def alternate_step_ms(dense, paged, pairs: int):
    """Host-clock ms of one ``dense()`` and one ``paged()`` decode step
    (each ended by a synchronize), ``pairs`` of each in turns dense,
    paged, paged, dense: each side's quartiles (the median between)."""
    times = {"dense": [], "paged": []}
    for i in range(pairs):
        order = ("dense", "paged") if i % 2 == 0 else ("paged", "dense")
        for side in order:
            fn = dense if side == "dense" else paged
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[side].append(1e3 * (time.perf_counter() - t0))
    return {side: [float(q) for q in np.percentile(t, [25, 50, 75])]
            for side, t in times.items()}


def paged_run(cfg, params, prompts, max_new: int, sc, stagger=False):
    """Serve ``prompts`` on a paged engine, the launch counters set to 0
    just before and read just after; with ``stagger`` the first request
    decodes its first token (its prompt pages published) before the
    others arrive.  Holds every request to its tokens and the launches to
    the per-step counts times the steps."""
    engine = ServingEngine(cfg, params, sc)
    reqs = [Request(prompt=p, max_new_tokens=max_new, rid=i)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    substrate.DISPATCH_COUNTS.clear()
    ag.reset_launches()                     # counts: 0 just before the run
    fa.reset_launches()
    t0 = time.perf_counter()
    engine.submit(reqs[0])
    if stagger:
        while not reqs[0].out_tokens:
            engine.step()
    for r in reqs[1:]:
        engine.submit(r)
    ticks = engine.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ag.LAUNCHES)            # read just after the run
    if fa.LAUNCHES["flash_attention"]:
        raise AssertionError("paged serving launched flash attention (K3)")
    st = engine.stats
    steps = st["prefill_dispatches"] + st["decode_dispatches"]
    for r in reqs:
        if not r.done or len(r.out_tokens) != max_new:
            raise AssertionError(f"paged request {r.rid}: done={r.done}, "
                                 f"{len(r.out_tokens)} of {max_new} tokens")
    what = (f"paged serving {cfg.name} on {cfg.gemm_backend} ({steps} steps "
            f"of {cfg.n_layers} layers)")
    check_clean(what, engine, reqs)
    check_launches(what, launches, expected_launches(cfg, steps))
    want = prefill_step_launches(cfg, st["prefill_dispatches"])
    if st["prefill_gemm_dispatches"] != want:
        raise AssertionError(f"{what}: {st['prefill_gemm_dispatches']} "
                             f"prefill K1/K2 launches, want {want}")
    ttft = [r.ttft_s for r in reqs]
    out = dict(
        requests=len(reqs), max_new=max_new, ticks=ticks, wall_s=wall,
        kv_pages=sc.kv_pages, page_size=engine.page_size,
        prefix_cache=sc.prefix_cache,
        kv_cache_bytes=engine.kv_cache_bytes(),
        pages_used_peak=st["pages_used_peak"],
        concurrency_peak=st["concurrency_peak"],
        prefix_hit_tokens=st["prefix_hit_tokens"],
        pool_used_after=engine.pool.n_used,
        prefill_tokens=st["prefill_tokens"],
        prefill_time_s=st["prefill_time_s"],
        prefill_dispatches=st["prefill_dispatches"],
        prefill_launches=st["prefill_gemm_dispatches"],
        decode_dispatches=st["decode_dispatches"],
        decode_step_ms=1e3 * st["decode_time_s"] / st["decode_dispatches"],
        mean_ttft_ms=1e3 * sum(ttft) / len(ttft),
        launches=launches, streams=[r.out_tokens for r in reqs])
    return out, engine


def paged_phase(cfg, params, serving):
    """Paged serving of full-width ``cfg`` against phase 5's dense runs
    (``serving``: backend -> its result): (a) phase 5's requests on each
    backend, streams bit-identical to the dense ones on ``arrayflex`` and
    ``arrayflex_int8`` and run to run on ``arrayflex_w8a8``, with the
    decode step profiled and timed alone against the dense one in turns;
    (b) eight short requests at ``max_batch`` 4, all resident at once;
    (c) requests sharing a system prompt, cold, warm (the prefix cache),
    warm and cold, the followers arriving once the first request has
    decoded."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    page = planner.page_plan(MAX_SEQ)
    pages = paged_pool_pages(PROMPT_LENS, MAX_NEW, MAX_SEQ, page)
    sc = ServeConfig(max_batch=BATCH, max_seq=MAX_SEQ, seed=0,
                     kv_pages=pages, page_size=page)
    out = {}
    for backend, dense in serving.items():
        bcfg = dataclasses.replace(cfg, gemm_backend=backend)
        warm = ServingEngine(bcfg, params, sc)
        warm_req = Request(prompt=prompts[0][:8], max_new_tokens=2)
        warm.submit(warm_req)
        warm.run_to_completion()
        check_clean(f"paged warm-up on {backend}", warm, [warm_req])
        del warm
        run, engine = paged_run(bcfg, params, prompts, MAX_NEW, sc)
        same = run["streams"] == dense["streams"]
        if backend == "arrayflex_w8a8":
            again, _ = paged_run(bcfg, params, prompts, MAX_NEW, sc)
            if again["streams"] != run["streams"]:
                raise AssertionError("paged arrayflex_w8a8: two runs gave "
                                     "different streams")
            run["repeat_launches"] = again["launches"]
        elif not same:
            raise AssertionError(f"paged {backend}: greedy streams differ "
                                 f"from the dense engine's")
        run["equals_dense"] = same
        run["dense_kv_cache_bytes"] = dense["kv_cache_bytes"]
        bt = torch.as_tensor(profile_block_tables(
            BATCH, engine.pages_per_seq, (MAX_SEQ // 2) // page),
            device="cuda")
        if int(bt.max()) >= engine.pool.n_pages:
            raise AssertionError(f"profile block tables need pages up to "
                                 f"{int(bt.max())}, the pool has "
                                 f"{engine.pool.n_pages}")
        toks = torch.zeros(BATCH, dtype=torch.int64, device="cuda")
        pos = torch.full((BATCH,), MAX_SEQ // 2, dtype=torch.int64,
                         device="cuda")
        run["profile"] = profile_device(
            lambda: lm.decode_step_paged(bcfg, engine.params, engine.cache,
                                         toks, pos, bt),
            run["decode_step_ms"], "paged decode step")
        cache = lm.init_cache(bcfg, BATCH, MAX_SEQ, device="cuda")
        run["alternated_step_ms"] = alternate_step_ms(
            lambda: lm.decode_step(bcfg, engine.params, cache, toks, pos),
            lambda: lm.decode_step_paged(bcfg, engine.params, engine.cache,
                                         toks, pos, bt), STEP_PAIRS)
        del cache
        dp = dense["profile"]
        alt = run["alternated_step_ms"]
        log(f"  {backend}: paged streams "
            f"{'==' if same else '!='} dense streams; kv_cache_bytes paged "
            f"{run['kv_cache_bytes']} ({pages} pages x {page}) / dense "
            f"{dense['kv_cache_bytes']}; pages_used_peak "
            f"{run['pages_used_peak']}; decode step {run['decode_step_ms']:.2f}"
            f" ms paged / {dense['decode_step_ms']:.2f} dense (host clock), "
            f"device busy {run['profile']['device_busy_ms']:.2f} / "
            f"{dp['device_busy_ms']:.2f} ms; one step alone, in turns "
            f"(quartiles) paged {alt['paged'][0]:.2f} / {alt['paged'][1]:.2f}"
            f" / {alt['paged'][2]:.2f}, dense {alt['dense'][0]:.2f} / "
            f"{alt['dense'][1]:.2f} / {alt['dense'][2]:.2f} ms; prefill "
            f"{1e3 * run['prefill_time_s']:.2f} / "
            f"{1e3 * dense['prefill_time_s']:.2f} ms, mean TTFT "
            f"{run['mean_ttft_ms']:.1f} / {dense['mean_ttft_ms']:.1f} ms")
        out[backend] = run
        del engine
        _free()

    short = [rng.integers(0, cfg.vocab_size, n).tolist()
             for n in PAGED_SHORT_LENS]
    sc = ServeConfig(max_batch=BATCH, max_seq=MAX_SEQ, seed=0,
                     kv_pages=paged_pool_pages(PAGED_SHORT_LENS,
                                               PAGED_SHORT_NEW, MAX_SEQ,
                                               page), page_size=page)
    run, _ = paged_run(cfg, params, short, PAGED_SHORT_NEW, sc)
    if run["concurrency_peak"] != len(short) or run["pool_used_after"]:
        raise AssertionError(
            f"paged: {len(short)} short requests at max_batch {BATCH}: "
            f"concurrency_peak {run['concurrency_peak']}, "
            f"{run['pool_used_after']} pages still in use")
    log(f"  {len(short)} short requests at max_batch {BATCH}: "
        f"concurrency_peak {run['concurrency_peak']}, pages_used_peak "
        f"{run['pages_used_peak']} of {sc.kv_pages - 1}, every request "
        f"finished, every page returned")
    out["concurrency"] = run

    shared = shared_prefix_prompts(cfg.vocab_size, PREFIX_REQUESTS,
                                   PREFIX_SYSTEM, PREFIX_TAIL)
    pages = paged_pool_pages([len(p) for p in shared], PREFIX_NEW, MAX_SEQ,
                             page)
    runs = []
    for prefix in (False, True, True, False):
        # the chunk is the page, as in the reference's schedule
        # (tests/test_serving_prefill.py): a cold follower prefills its
        # prompt in two chunks, a warm one its tail in one
        sc = ServeConfig(max_batch=BATCH, max_seq=MAX_SEQ, seed=0,
                         prefill_chunk=page, kv_pages=pages, page_size=page,
                         prefix_cache=prefix)
        run, _ = paged_run(cfg, params, shared, PREFIX_NEW, sc,
                           stagger=True)
        runs.append(run)
        log(f"  prefix {'warm' if prefix else 'cold'}: "
            f"{run['prefill_tokens']} prefill tokens in "
            f"{run['prefill_dispatches']} dispatches, "
            f"{1e3 * run['prefill_time_s']:.2f} ms, "
            f"{run['prefill_launches']} prefill K1/K2 launches; mean TTFT "
            f"{run['mean_ttft_ms']:.1f} ms; prefix hits "
            f"{run['prefix_hit_tokens']} tokens")
    for c, w in ((runs[0], runs[1]), (runs[3], runs[2])):
        if (w["streams"] != c["streams"] or not w["prefix_hit_tokens"]
                or w["prefill_tokens"] >= c["prefill_tokens"]
                or w["prefill_launches"] >= c["prefill_launches"]):
            raise AssertionError(
                f"prefix cache: streams equal {w['streams'] == c['streams']}"
                f", hits {w['prefix_hit_tokens']}, prefill tokens "
                f"{w['prefill_tokens']} vs {c['prefill_tokens']}, prefill "
                f"launches {w['prefill_launches']} vs "
                f"{c['prefill_launches']}")
    out["prefix_cold"], out["prefix_warm"] = runs[0], runs[1]
    out["prefix_warm_2"], out["prefix_cold_2"] = runs[2], runs[3]
    return out


# ---------------------------------------------------------------------------
# phase 5, resilience: typed outcomes, retries, seeded chaos, preemption and
# crash snapshots

# (b): layer 0's attn.pv, the fifth of the nine sites a trace draws (eight
# of one layer, then the unembed), in the first prefill trace (draws 0-8)
# and then in the first decode trace (draws 9-17)
GEMM_FAULT_PREFILL, GEMM_FAULT_DECODE = 4, 9 + 4
# (d): the engine.tick draw the engine is killed at: tick 7 of the dense
# runs' 16 (tick 1 prefills and decodes, then one token a tick)
CRASH_TICK = 6
# (e): the scratch page and four of 128 tokens, where the batch's worst
# case needs five (the 128-token prompt grows into a second page)
PREEMPT_PAGES = 5
# one decode step alone and one retried after an injected fault, in turns
RETRY_PAIRS = 10


def resilient_run(cfg, params, prompts, max_new: int, sc, stagger=False,
                  per_dispatch=False):
    """Serve ``prompts`` on ``sc``, restoring the engine from its latest
    snapshot after each injected crash (the crashed engine released
    first), the launch counters set to 0 just before and read just after;
    with ``stagger`` the first request decodes its first token before the
    others arrive.  Holds the launches to :func:`retried_launches`, the
    outcome counters to the requests, and the card's allocated bytes just
    before each restore to what they were before the first engine was
    built (the crashed engine gone); ``per_dispatch`` as in
    :func:`retried_launches`."""
    what = (f"resilient serving {cfg.name} on {cfg.gemm_backend} "
            f"({sc.chaos})")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    engine = ServingEngine(cfg, params, sc)
    engine_bytes = torch.cuda.memory_allocated() - base
    reqs = [Request(prompt=p, max_new_tokens=max_new, rid=i)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    built = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    substrate.DISPATCH_COUNTS.clear()
    ag.reset_launches()                     # counts: 0 just before the run
    fa.reset_launches()
    t0 = time.perf_counter()
    engine.submit(reqs[0])
    if stagger:
        while not reqs[0].out_tokens:
            engine.step()
    for r in reqs[1:]:
        engine.submit(r)
    restore_s = []
    while True:
        try:
            engine.run_to_completion()
            break
        except EngineCrash:
            if len(restore_s) == 3:
                raise AssertionError("crash recovery livelocked")
            snap = engine.latest_snapshot()
        engine = None           # its tree and cache leave the card first
        gc.collect()
        left = torch.cuda.memory_allocated() - base
        if left > engine_bytes // 8:
            raise AssertionError(
                f"{what}: {left} B still allocated after the crashed "
                f"engine ({engine_bytes} B) was released")
        t1 = time.perf_counter()
        engine = ServingEngine.restore(cfg, params, sc, snap)
        torch.cuda.synchronize()
        restore_s.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ag.LAUNCHES)            # read just after the run
    if fa.LAUNCHES["flash_attention"]:
        raise AssertionError("resilient serving launched flash attention")
    peak = torch.cuda.max_memory_allocated() - built
    final = {r.rid: r for r in reqs}
    for r in engine.restored_requests:
        final[r.rid] = r
    reqs = [final[r.rid] for r in reqs]
    st = engine.stats
    chaos_log = list(engine._chaos.chaos_log) if engine._chaos else []
    check_launches(what, launches, retried_launches(cfg, st, chaos_log,
                                                    per_dispatch))
    outcomes = [r.outcome for r in reqs]
    counted = sum(v for k, v in st.items() if k.startswith("outcome_"))
    if None in outcomes or counted != len(reqs):
        raise AssertionError(f"{what}: outcomes {outcomes}, {counted} "
                             f"counted for {len(reqs)} requests")
    return dict(
        streams=[r.out_tokens for r in reqs], outcomes=outcomes,
        errors=[r.error.split(":")[0] for r in reqs],
        stats={k: st[k] for k in (
            "prefill_dispatches", "decode_dispatches", "prefill_tokens",
            "decode_tokens", "sample_retries", "kernel_fault_retries",
            "preemptions", "watchdog_fired", "snapshots_taken",
            "pages_used_peak", "prefix_hit_tokens", "outcome_ok",
            "outcome_preempted_retried", "outcome_failed")},
        chaos_log=chaos_log, restarts=len(restore_s), restore_s=restore_s,
        wall_s=wall, engine_bytes=engine_bytes, peak_above_engine=peak,
        launches=launches), engine


def _require(what: str, run, streams=None, ok=True, **stats):
    """``run`` gave ``streams`` (when given), every request ``ok`` (when
    asked) and these stats counters exactly."""
    bad = {k: (run["stats"][k], v) for k, v in stats.items()
           if run["stats"][k] != v}
    if ((streams is not None and run["streams"] != streams) or bad
            or (ok and any(o != "ok" for o in run["outcomes"]))):
        raise AssertionError(
            f"{what}: streams equal "
            f"{streams is None or run['streams'] == streams}, outcomes "
            f"{run['outcomes']} {run['errors']}, counters (got, want) {bad}")


def snapshot_ms(engine, n: int = 5) -> float:
    """Median host-clock ms of one ``engine.snapshot()`` (the K/V cache
    copied to host memory)."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.snapshot()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def retry_step_ms(cfg, engine, pairs: int = RETRY_PAIRS):
    """Host-clock ms (median) of one full-batch decode step alone, and of
    one whose first attempt took an injected GEMM fault and was run again:
    at layer 0's attn.pv (the (b) site) and at the unembed (the last
    dispatch: every layer launched before the fault), in turns.  Every
    dispatch draws here (no trace scope), so the fault lands at that
    dispatch."""
    toks = torch.zeros(BATCH, dtype=torch.int64, device="cuda")
    pos = torch.full((BATCH,), MAX_SEQ // 2, dtype=torch.int64,
                     device="cuda")
    seq = step_sites(cfg)

    def step():
        lm.decode_step(cfg, engine.params, engine.cache, toks, pos)

    def retried(n):
        def run():
            with chaos.scope(ChaosEngine(ChaosConfig(gemm_fault_at=n))):
                try:
                    step()
                except KernelFault:
                    pass
                else:
                    raise AssertionError(f"no fault at dispatch {n}")
            step()
        return run

    fns = {"clean": step, "attn.pv": retried(seq.index("attn.pv")),
           "unembed": retried(len(seq) - 1)}
    times = {k: [] for k in fns}
    step()
    for i in range(pairs):
        for k in (fns if i % 2 == 0 else list(fns)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[k]()
            torch.cuda.synchronize()
            times[k].append(1e3 * (time.perf_counter() - t0))
    return {k: float(np.median(v)) for k, v in times.items()}


def resilience_phase(cfg, params, serving, paged):
    """The hardened engine on full-width ``cfg`` against phase 5's runs
    (``serving``: backend -> its dense result; ``paged``: the paged
    results): (a) chaos seeded but quiet, snapshots every 2 ticks; (b) a
    transient GEMM fault in the prefill trace, then in the decode trace;
    (c) a transient NaN; (d) a crash mid-decode restored from a snapshot
    taken every tick, dense on ``arrayflex`` and ``arrayflex_int8`` and
    paged with the prefix cache; (e) preemption on a pool below the
    batch's worst case; (f) persistent GEMM faults, then persistent NaNs.
    Every stream equals its clean run's; every launch count is exact."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    base = dict(max_batch=BATCH, max_seq=MAX_SEQ, seed=0)
    page = planner.page_plan(MAX_SEQ)
    dense = serving["arrayflex"]["streams"]
    runs, out = [], {}

    def serve(key, what, bcfg=cfg, ps=prompts, max_new=MAX_NEW,
              stagger=False, **sc_kw):
        run, engine = resilient_run(bcfg, params, ps, max_new,
                                    ServeConfig(**base, **sc_kw),
                                    stagger=stagger)
        runs.append(run)
        out[key] = run
        st = run["stats"]
        log(f"  {what}: {st['prefill_dispatches']} prefill + "
            f"{st['decode_dispatches']} decode dispatches, retries "
            f"{st['kernel_fault_retries']} fault / {st['sample_retries']} "
            f"NaN, chaos log {run['chaos_log']}, outcomes "
            f"{sorted(set(run['outcomes']))}, {run['wall_s']:.3f} s")
        return run, engine

    run, _ = serve("quiet", "(a) chaos seed=123, snapshot every 2 ticks",
                   chaos=ChaosConfig(seed=123), snapshot_every_ticks=2)
    _require("(a)", run, dense, sample_retries=0, kernel_fault_retries=0,
             watchdog_fired=0)
    if run["chaos_log"] or not run["stats"]["snapshots_taken"]:
        raise AssertionError(f"(a): chaos log {run['chaos_log']}, "
                             f"{run['stats']['snapshots_taken']} snapshots")
    for key, n in (("gemm_prefill", GEMM_FAULT_PREFILL),
                   ("gemm_decode", GEMM_FAULT_DECODE)):
        run, engine = serve(key, f"(b) gemm_fault_at={n}",
                            chaos=ChaosConfig(gemm_fault_at=n))
        _require(f"(b) gemm_fault_at={n}", run, dense,
                 kernel_fault_retries=1, sample_retries=0)
    retry = retry_step_ms(cfg, engine)
    out["retry_step_ms"] = retry
    log(f"  one decode step alone {retry['clean']:.2f} ms; retried after a "
        f"fault at layer 0's attn.pv {retry['attn.pv']:.2f} ms, at the "
        f"unembed {retry['unembed']:.2f} ms (host clock, medians of "
        f"{RETRY_PAIRS} in turns)")
    run, _ = serve("nan", "(c) nan_logits_at=0",
                   chaos=ChaosConfig(nan_logits_at=0))
    _require("(c)", run, dense, sample_retries=1, kernel_fault_retries=0)

    for backend in ("arrayflex", "arrayflex_int8"):
        bcfg = dataclasses.replace(cfg, gemm_backend=backend)
        run, engine = serve(f"crash_{backend}",
                            f"(d) {backend} crash_at={CRASH_TICK}",
                            bcfg=bcfg, snapshot_every_ticks=1,
                            chaos=ChaosConfig(crash_at=CRASH_TICK))
        _require(f"(d) {backend}", run, serving[backend]["streams"],
                 kernel_fault_retries=0, sample_retries=0)
        run["snapshot_ms"] = snapshot_ms(engine)
        run["kv_cache_bytes"] = engine.kv_cache_bytes()
        log(f"    restarts {run['restarts']}, restore "
            f"{1e3 * run['restore_s'][0]:.1f} ms, snapshot "
            f"{run['snapshot_ms']:.2f} ms a tick ({run['kv_cache_bytes']} B "
            f"of K/V to host); the run's peak {run['peak_above_engine']} B "
            f"above one built engine's {run['engine_bytes']} B (the "
            f"restore's own build included)")
        if run["restarts"] != 1:
            raise AssertionError(f"(d) {backend}: {run['restarts']} "
                                 f"restarts, want 1")
    warm = paged["prefix_warm"]
    shared = shared_prefix_prompts(cfg.vocab_size, PREFIX_REQUESTS,
                                   PREFIX_SYSTEM, PREFIX_TAIL)
    run, engine = serve(
        "crash_paged_prefix", f"(d) paged prefix crash_at={CRASH_TICK}",
        ps=shared, max_new=PREFIX_NEW, stagger=True, prefill_chunk=page,
        kv_pages=warm["kv_pages"], page_size=page, prefix_cache=True,
        snapshot_every_ticks=1, chaos=ChaosConfig(crash_at=CRASH_TICK))
    _require("(d) paged prefix", run, warm["streams"],
             kernel_fault_retries=0, sample_retries=0)
    run["snapshot_ms"] = snapshot_ms(engine)
    run["kv_cache_bytes"] = engine.kv_cache_bytes()
    log(f"    restarts {run['restarts']}, restore "
        f"{1e3 * run['restore_s'][0]:.1f} ms, snapshot "
        f"{run['snapshot_ms']:.2f} ms a tick ({run['kv_cache_bytes']} B of "
        f"pool to host); prefix hits {run['stats']['prefix_hit_tokens']} "
        f"tokens (warm run {warm['prefix_hit_tokens']})")
    if run["restarts"] != 1:
        raise AssertionError(f"(d) paged: {run['restarts']} restarts")
    del engine

    clean_prefill = sum(n - 1 for n in PROMPT_LENS)
    for backend in ("arrayflex", "arrayflex_int8"):
        bcfg = dataclasses.replace(cfg, gemm_backend=backend)
        run, _ = serve(f"preempt_{backend}",
                       f"(e) {backend} {PREEMPT_PAGES} pages, youngest",
                       bcfg=bcfg, kv_pages=PREEMPT_PAGES, page_size=page,
                       preempt_policy="youngest")
        _require(f"(e) {backend}", run, serving[backend]["streams"],
                 ok=False, kernel_fault_retries=0, sample_retries=0)
        st = run["stats"]
        run["recomputed_prefill_tokens"] = st["prefill_tokens"] -             clean_prefill
        if (not st["preemptions"] or st["outcome_failed"]
                or st["outcome_ok"] + st["outcome_preempted_retried"]
                != len(prompts)):
            raise AssertionError(f"(e) {backend}: {st}")
        log(f"    preemptions {st['preemptions']}, prefill tokens "
            f"{st['prefill_tokens']} ({run['recomputed_prefill_tokens']} "
            f"recomputed), pages_used_peak {st['pages_used_peak']}, "
            f"outcomes {run['outcomes']}")

    for key, spec in (("persistent_gemm", dict(gemm_fault=1.0)),
                      ("persistent_nan", dict(nan_logits=1.0))):
        run, _ = serve(key, f"(f) {spec}", chaos=ChaosConfig(**spec))
        if any(o != "failed" for o in run["outcomes"]):
            raise AssertionError(f"(f) {spec}: outcomes {run['outcomes']}")
    out["runs"] = runs
    return out



# ---------------------------------------------------------------------------
# phase 5, disaggregated: the prefill role's own cache, the K/V handoff,
# per-role clocks and role-priced plans

# (d): the disagg.pod draw the decode pod is lost at (one draw a tick):
# tick 5, every request decoding
POD_LOST_AT = 4
# (e): the pipeline the decode role prices (no mesh: pricing only)
ROLE_PP_STAGES = 2


def _row_bytes(cache) -> int:
    """Bytes of one row (dense: a slot; paged: a page) of every leaf."""
    return sum(t[:, 0].numel() * t.element_size()
               for layer in cache for t in layer.values())


def disagg_run(cfg, params, prompts, max_new: int, sc):
    """Serve ``prompts`` on a DisaggServingEngine (``sc``), the launch
    counters set to 0 just before and read just after, each handoff's
    copy timed on the host clock (the engine's copy ends with a
    synchronize).  Holds the launches to the per-step counts times the
    steps dispatched (no chaos here faults a GEMM) and the handoff bytes
    to the handoffs times a row's (dense) or the pages moved times a
    page's (paged)."""
    engine = DisaggServingEngine(cfg, params, sc)
    handoffs = []
    copy = engine._copy

    def timed_copy(index):
        t0 = time.perf_counter()
        n = copy(index)
        handoffs.append((1e3 * (time.perf_counter() - t0), n))
        return n

    engine._copy = timed_copy
    reqs = [Request(prompt=p, max_new_tokens=max_new, rid=i)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    torch.cuda.synchronize()
    substrate.DISPATCH_COUNTS.clear()
    ag.reset_launches()                     # counts: 0 just before the run
    fa.reset_launches()
    t0 = time.perf_counter()
    ticks = engine.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ag.LAUNCHES)            # read just after the run
    if fa.LAUNCHES["flash_attention"]:
        raise AssertionError("disaggregated serving launched flash "
                             "attention (K3)")
    st = engine.stats
    steps = st["prefill_dispatches"] + st["decode_dispatches"]
    what = (f"disaggregated serving {cfg.name} on {cfg.gemm_backend} "
            f"({steps} steps of {cfg.n_layers} layers, {sc.chaos})")
    check_launches(what, launches, engine_launches(cfg, steps))
    row = _row_bytes(engine.pcache)
    moved = (st["kv_transfer_pages"] if engine.paged else len(handoffs))
    if (st["kv_transfer_bytes"] != moved * row
            or sum(n for _, n in handoffs) != st["kv_transfer_bytes"]):
        raise AssertionError(
            f"{what}: kv_transfer_bytes {st['kv_transfer_bytes']}, want "
            f"{moved} x {row} B ({len(handoffs)} handoffs)")
    out = dict(
        streams=[r.out_tokens for r in reqs],
        outcomes=[r.outcome for r in reqs],
        errors=[r.error.split(":")[0] for r in reqs],
        stats={k: st[k] for k in (
            "prefill_dispatches", "decode_dispatches", "prefill_tokens",
            "decode_tokens", "kv_transfer_bytes", "kv_transfer_pages",
            "transfer_retries", "pod_losses", "preemptions",
            "kernel_fault_retries", "sample_retries")},
        prefill_chunk=engine.prefill_chunk, ticks=ticks, wall_s=wall,
        prefill_time_s=st["prefill_time_s"],
        decode_time_s=st["decode_time_s"],
        makespan_s=max(st["prefill_time_s"], st["decode_time_s"]),
        colocated_sum_s=st["prefill_time_s"] + st["decode_time_s"],
        ttft_virtual_ms=[1e3 * engine.ttft_virtual[r.rid]
                         if r.rid in engine.ttft_virtual else None
                         for r in reqs],
        ttft_wall_ms=[None if r.ttft_s is None else 1e3 * r.ttft_s
                      for r in reqs],
        handoff_ms=[ms for ms, _ in handoffs],
        handoff_bytes=[n for _, n in handoffs], row_bytes=row,
        launches=launches)
    return out, engine


def engine_launches(cfg, steps: int) -> dict:
    """:func:`expected_launches` for ``steps`` engine steps.  The engine's
    K/V cache is bf16 whatever the compute dtype, and attention casts its
    probabilities to the cache's dtype, so in an fp32-compute run each
    attn.pv still multiplies bf16 operands and lands on K2's tensor-core
    kernel (its subset counter); every other fp32 launch is on FFMA."""
    want = expected_launches(cfg, steps)
    if cfg.compute_dtype == "float32":
        want["arrayflex_expert_gemm_tc"] += (
            step_sites(cfg).count("attn.pv") * steps)
    return want


def _first_divergence(got, want):
    """(request, token index) of the first token two stream lists differ
    at, or None."""
    for i, (g, w) in enumerate(zip(got, want)):
        for j, (a, b) in enumerate(zip(g, w)):
            if a != b:
                return (i, j)
        if len(g) != len(w):
            return (i, min(len(g), len(w)))
    return None


def _require_disagg(what: str, run, streams=None, outcome="ok", error="",
                    **stats):
    """``run`` gave ``streams`` (when given), every request ``outcome``
    (its error type ``error``) and these stats counters exactly."""
    bad = {k: (run["stats"][k], v) for k, v in stats.items()
           if run["stats"][k] != v}
    if ((streams is not None and run["streams"] != streams) or bad
            or any(o != outcome for o in run["outcomes"])
            or any(e != error for e in run["errors"])):
        raise AssertionError(
            f"{what}: streams equal "
            f"{streams is None or run['streams'] == streams}, outcomes "
            f"{run['outcomes']} {run['errors']}, counters (got, want) {bad}")


def _log_disagg(what: str, run, colo, card: str):
    """The run's role clocks, makespan against the colocated sum, each
    request's virtual TTFT against the colocated engine's wall TTFT, and
    its handoff's time and bytes, beside the card line."""
    log(f"  {what}: role clocks prefill_time_s "
        f"{run['prefill_time_s']:.6f} / decode_time_s "
        f"{run['decode_time_s']:.6f}; makespan {run['makespan_s']:.6f} s "
        f"against the colocated sum {run['colocated_sum_s']:.6f} s "
        f"(colocated engine: prefill {colo['prefill_time_s']:.6f} + decode "
        f"{colo['decode_time_s']:.6f} s); chunk {run['prefill_chunk']} "
        f"(card: {card})")
    for i, (vt, wt) in enumerate(zip(run["ttft_virtual_ms"],
                                     colo["ttft_ms"])):
        hand = (f"handoff {run['handoff_ms'][i]:.3f} ms, "
                f"{run['handoff_bytes'][i]} B"
                if i < len(run["handoff_ms"]) else "no handoff")
        log(f"    request {i}: virtual TTFT "
            f"{'none' if vt is None else f'{vt:.3f}'} ms against colocated "
            f"wall TTFT {wt:.3f} ms; {hand} (card: {card})")


def disagg_phase(cfg, params, serving, paged, card: str):
    """Disaggregated serving of full-width ``cfg`` (1 + 1 pods, pp = 1)
    against phase 5's runs (``serving``: backend -> its dense result;
    ``paged``: the paged results): (a) on each backend with the prefill
    chunk pinned to the colocated one, streams equal bit for bit; (b) on
    ``arrayflex`` with the prefill role's re-picked chunk, its first
    divergence from colocated printed (another row count may pick another
    K1 tile form on the card); (c) paged, against the paged run, the
    live pages moved; (d) a dropped handoff retried, a persistent drop
    (every prefilled request ``failed`` with ``TransferFault``) and a
    decode-pod loss (every request ``preempted_retried`` with (a)'s
    streams); (e) one decode step under the decode role of a
    two-stage pipeline (no mesh): attn.wq launched at the role's k, the
    logits equal the colocated step's.  Every run's launches are the
    per-step counts times its steps."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    base = dict(max_batch=BATCH, max_seq=MAX_SEQ, seed=0, prefill_pods=1,
                decode_pods=1)
    out, runs = {}, []
    handoffs = sum(n > 1 for n in PROMPT_LENS)
    for backend, colo in serving.items():
        bcfg = dataclasses.replace(cfg, gemm_backend=backend)
        run, _ = disagg_run(bcfg, params, prompts, MAX_NEW, DisaggServeConfig(
            **base, prefill_chunk=colo["prefill_chunk"]))
        _require_disagg(f"(a) {backend}", run, colo["streams"],
                        transfer_retries=0, kernel_fault_retries=0,
                        sample_retries=0)
        if len(run["handoff_ms"]) != handoffs:
            raise AssertionError(f"(a) {backend}: {len(run['handoff_ms'])} "
                                 f"handoffs, want {handoffs}")
        _log_disagg(f"(a) {backend}, chunk pinned: streams == colocated, "
                    f"kv_transfer_bytes {run['stats']['kv_transfer_bytes']}"
                    f" = {handoffs} x {run['row_bytes']} B", run, colo, card)
        runs.append(run)
        out[f"pinned_{backend}"] = run
        _free()

    colo = serving["arrayflex"]
    run, _ = disagg_run(cfg, params, prompts, MAX_NEW,
                        DisaggServeConfig(**base))
    _require_disagg("(b)", run, None, transfer_retries=0,
                    kernel_fault_retries=0, sample_retries=0)
    run["first_divergence"] = _first_divergence(run["streams"],
                                                colo["streams"])
    _log_disagg(f"(b) arrayflex, the prefill role's re-picked chunk "
                f"{run['prefill_chunk']} (colocated {colo['prefill_chunk']})"
                f": first divergence from colocated "
                f"{run['first_divergence']}", run, colo, card)
    runs.append(run)
    out["repicked_arrayflex"] = run

    page = planner.page_plan(MAX_SEQ)
    live = sum(-(-(n - 1) // page) for n in PROMPT_LENS)
    run, _ = disagg_run(cfg, params, prompts, MAX_NEW, DisaggServeConfig(
        **base, prefill_chunk=colo["prefill_chunk"],
        kv_pages=paged["arrayflex"]["kv_pages"], page_size=page))
    _require_disagg("(c) paged", run, paged["arrayflex"]["streams"],
                    kv_transfer_pages=live, transfer_retries=0)
    _log_disagg(f"(c) arrayflex paged (page {page}): streams == paged "
                f"colocated, {live} live pages moved "
                f"({run['stats']['kv_transfer_bytes']} B)", run, colo, card)
    runs.append(run)
    out["paged_arrayflex"] = run

    pinned = dict(base, prefill_chunk=colo["prefill_chunk"])
    want = out["pinned_arrayflex"]["streams"]
    for key, sc, check in (
            ("transfer_retry", DisaggServeConfig(
                **pinned, max_retries=2,
                chaos=ChaosConfig(kv_transfer_at=0)),
             dict(streams=want, transfer_retries=1)),
            ("transfer_persistent", DisaggServeConfig(
                **pinned, max_retries=0, chaos=ChaosConfig(kv_transfer=1.0)),
             dict(outcome="failed", error="TransferFault",
                  kv_transfer_bytes=0, decode_dispatches=0)),
            ("pod_loss", DisaggServeConfig(
                **pinned, chaos=ChaosConfig(pod_lost_at=POD_LOST_AT)),
             dict(streams=want, outcome="preempted_retried", pod_losses=1,
                  preemptions=len(PROMPT_LENS)))):
        run, engine = disagg_run(cfg, params, prompts, MAX_NEW, sc)
        _require_disagg(f"(d) {key}", run, kernel_fault_retries=0,
                        sample_retries=0, **check)
        run["chaos_log"] = [tuple(e) for e in engine._chaos.chaos_log]
        log(f"  (d) {key}: outcomes {sorted(set(run['outcomes']))} "
            f"{sorted(set(run['errors']))}, transfer retries "
            f"{run['stats']['transfer_retries']}, pod losses "
            f"{run['stats']['pod_losses']}, prefill tokens "
            f"{run['stats']['prefill_tokens']}, chaos log "
            f"{run['chaos_log']}; {run['wall_s']:.3f} s (card: {card})")
        runs.append(run)
        out[key] = run
        del engine
        _free()

    out["role_pricing"], role_launches = role_pricing_phase(cfg, params, card)
    runs += [{"launches": v} for v in role_launches]
    out["runs"] = runs
    return out


def role_pricing_phase(cfg, params, card: str):
    """(e): one full-batch decode step of ``cfg`` colocated, then under
    ``pp_role="decode", pp_stages=ROLE_PP_STAGES`` (no mesh: the decode
    role's stage-ingress cycles priced into attn.wq's plan), each on a
    fresh cache, counted from 0 and held to one step's launches, its K1 /
    K2 launches recorded: attn.wq must launch at the k its plan took under
    the role's transfer terms, and the logits must equal the colocated
    step's (plans move k, never values)."""
    p = lm.prepare_params(cfg, params)
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, BATCH),
                           device="cuda")
    pos = torch.full((BATCH,), MAX_SEQ // 2, dtype=torch.int64,
                     device="cuda")
    role = dataclasses.replace(cfg, pp_role="decode",
                               pp_stages=ROLE_PP_STAGES)
    ks, logits, planned, launches = {}, {}, {}, []
    for name, c in (("colocated", cfg), ("decode", role)):
        cache = lm.init_cache(c, BATCH, MAX_SEQ)
        torch.cuda.synchronize()
        ag.reset_launches()                 # counts: 0 just before
        with recorded_sites(cfg.name) as sites:
            lg, _ = lm.decode_step(c, p, cache, toks, pos)
        torch.cuda.synchronize()
        counted = dict(ag.LAUNCHES)         # read just after
        check_launches(f"(e) {name} decode step", counted,
                       expected_launches(c, 1))
        launches.append(counted)
        wq = {st.k for st in sites if st.name == sharding.PP_BOUNDARY_SITE}
        if len(wq) != 1:
            raise AssertionError(f"(e) {name}: attn.wq launched at k {wq}")
        ks[name] = wq.pop()
        planned[name] = substrate.SITE_PLANS[sharding.PP_BOUNDARY_SITE]
        logits[name] = lg.float()
        del cache
    d = cfg.d_model
    t_ops, t_cyc = sharding.pp_transfer_terms("decode", ROLE_PP_STAGES,
                                              BATCH, d)
    sig = planned["decode"].shard
    if ((sig.transfer_ops, sig.transfer_cycles) != (t_ops, t_cyc)
            or planned["colocated"].shard != substrate.SHARD_NONE
            or ks["decode"] != planned["decode"].k
            or ks["colocated"] != planned["colocated"].k):
        raise AssertionError(
            f"(e): attn.wq launched at k {ks}, planned "
            f"{ {n: (pl.k, pl.shard) for n, pl in planned.items()} }, the "
            f"role's terms ({t_ops}, {t_cyc})")
    equal = bool(torch.equal(logits["decode"], logits["colocated"]))
    log(f"  (e) decode step under pp_role=decode, pp_stages="
        f"{ROLE_PP_STAGES} (no mesh): attn.wq at k {ks['decode']} (plan "
        f"with {t_cyc} ingress cycles) against colocated k "
        f"{ks['colocated']}; logits equal the colocated step's: {equal} "
        f"(card: {card})")
    if not equal:
        raise AssertionError("(e): the role's logits differ from the "
                             "colocated step's")
    del p
    _free()
    return dict(k=ks, transfer_cycles=t_cyc, logits_equal=equal), launches


def disagg_fp32_parity(cfg, params, card: str):
    """(b) in fp32: phase 5's requests on a colocated engine and on the
    disaggregated one with the prefill role's re-picked chunk, fp32
    compute: streams equal.  Each run counted from 0 and held to
    :func:`engine_launches` (FFMA but attn.pv, which reads the engine's
    bf16 cache)."""
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    colo = serving_run_fp32(c32, params, prompts)
    run, _ = disagg_run(c32, params, prompts, MAX_NEW, DisaggServeConfig(
        max_batch=BATCH, max_seq=MAX_SEQ, seed=0, prefill_pods=1,
        decode_pods=1))
    equal = run["streams"] == colo["streams"]
    log(f"  fp32 disaggregated (re-picked chunk {run['prefill_chunk']}) "
        f"against fp32 colocated (chunk {colo['prefill_chunk']}): streams "
        f"equal {equal}; first divergence "
        f"{_first_divergence(run['streams'], colo['streams'])} "
        f"(card: {card})")
    if not equal or any(o != "ok" for o in run["outcomes"]):
        raise AssertionError(f"fp32 disaggregated: streams equal {equal}, "
                             f"outcomes {run['outcomes']}")
    _free()
    return (dict(streams_equal=equal, prefill_chunk=run["prefill_chunk"],
                 colocated_chunk=colo["prefill_chunk"]),
            [colo["launches"], run["launches"]])


def serving_run_fp32(cfg, params, prompts):
    """Phase 5's requests on a colocated engine, counted from 0 and held
    to the per-step counts."""
    engine = ServingEngine(cfg, params, ServeConfig(
        max_batch=BATCH, max_seq=MAX_SEQ, seed=0))
    reqs = [Request(prompt=p, max_new_tokens=MAX_NEW, rid=i)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    torch.cuda.synchronize()
    ag.reset_launches()                     # counts: 0 just before
    engine.run_to_completion()
    torch.cuda.synchronize()
    launches = dict(ag.LAUNCHES)            # read just after
    st = engine.stats
    check_clean(f"fp32 serving {cfg.name}", engine, reqs)
    check_launches(f"fp32 serving {cfg.name}", launches, engine_launches(
        cfg, st["prefill_dispatches"] + st["decode_dispatches"]))
    return dict(streams=[r.out_tokens for r in reqs], launches=launches,
                prefill_chunk=engine.prefill_chunk)

# ---------------------------------------------------------------------------
# phase 5: the mesh — sharded dispatch over logical devices on the card,
# and the pipelined disaggregated engine

# the (data, model) meshes the sharded engine serves on, and the tp of the
# MoE and SSM decode steps
MESH_SHAPES = ((1, 2), (2, 2))
MESH_TP = 2
# the pipelined roles: 2 prefill pods + 2 decode pods, pp = 2
PP = 2
# the reference's sharded tolerance for logits (fp32),
# tests/test_sharded_substrate.py
SHARDED_TOL = dict(rtol=1e-4, atol=1e-3)


def mesh_ctx(cfg, site: str, rows: int, mesh):
    """The shard context ``site``'s dispatch of ``rows`` rows takes on
    ``cfg`` under ``mesh`` (``parallel.sharding``'s rules at the site's
    (K, N)), or None: replicated."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    if site in ("attn.qk", "attn.pv"):
        return sharding.batched_shard_ctx(BATCH * KV, mesh)
    if site in ("moe.wi_gate", "moe.wi_up", "moe.wo"):
        return sharding.expert_shard_ctx(cfg.moe.num_experts, mesh)
    ssm = cfg.ssm
    kn = {"attn.wq": (d, H * hd), "attn.wk": (d, KV * hd),
          "attn.wv": (d, KV * hd), "attn.wo": (H * hd, d),
          "mlp.wi_gate+mlp.wi_up": (d, cfg.d_ff), "mlp.wo": (cfg.d_ff, d),
          "unembed": (d, cfg.padded_vocab)}
    if cfg.moe is not None:
        kn["moe.router"] = (d, cfg.moe.num_experts)
    if ssm is not None:
        conv = cfg.d_inner + 2 * ssm.n_groups * ssm.d_state
        kn.update({"mamba.z": (d, cfg.d_inner), "mamba.xbc": (d, conv),
                   "mamba.dt": (d, cfg.ssm_heads),
                   "mamba.out": (cfg.d_inner, d)})
    K, N = kn[site]
    ctx = sharding.gemm_shard_ctx(site, rows, K, N, mesh)
    return ctx if ctx is not None and ctx.divides(rows, K, N) else None


def mesh_shards(cfg, site: str, rows: int, mesh) -> int:
    """The launches one dispatch of ``site`` makes for each it makes
    unsharded: one per distinct shard of its context (1 replicated)."""
    ctx = mesh_ctx(cfg, site, rows, mesh)
    if ctx is None:
        return 1
    return len(substrate._shard_coords(mesh, ctx.x_spec, ctx.w_spec,
                                       ctx.out_spec))


def mesh_launches(cfg, steps: dict, mesh) -> dict:
    """Kernel launches of engine steps on ``mesh``: each step dispatches
    :func:`step_sites`, each dispatch launching :func:`site_launches`
    once per shard of its context.  ``steps``: rows per dispatch -> steps
    (a decode step's rows are BATCH, a prefill chunk's BATCH x chunk)."""
    want = {name: 0 for name in ag.LAUNCHES}
    for rows, n in steps.items():
        for site in step_sites(cfg):
            shards = mesh_shards(cfg, site, rows, mesh)
            for name, c in site_launches(cfg, site).items():
                want[name] += c * shards * n
    if cfg.compute_dtype == "float32":      # attn.pv reads the bf16 cache
        for rows, n in steps.items():
            want["arrayflex_expert_gemm_tc"] += n * mesh_shards(
                cfg, "attn.pv", rows, mesh) * step_sites(cfg).count(
                    "attn.pv")
    return want


def mesh_serving_run(cfg, params, prompts):
    """Phase 5's requests on a ServingEngine at ``cfg.mesh_shape`` (its
    mesh over the active logical devices), counted from 0 just before the
    run and read just after, held to :func:`mesh_launches` over its
    prefill-chunk and decode steps; the weight-block memo's size after
    the run (the column blocks copied contiguous once)."""
    substrate.clear_shard_cache()
    engine = ServingEngine(cfg, params, ServeConfig(
        max_batch=BATCH, max_seq=MAX_SEQ, seed=0))
    reqs = [Request(prompt=p, max_new_tokens=MAX_NEW, rid=i)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    torch.cuda.synchronize()
    ag.reset_launches()                     # counts: 0 just before
    fa.reset_launches()
    t0 = time.perf_counter()
    engine.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ag.LAUNCHES)            # read just after
    if fa.LAUNCHES["flash_attention"]:
        raise AssertionError("mesh serving launched flash attention (K3)")
    st = engine.stats
    what = (f"mesh {cfg.mesh_shape} serving {cfg.name} on "
            f"{cfg.gemm_backend}/{cfg.compute_dtype}")
    check_clean(what, engine, reqs)
    steps = {BATCH: st["decode_dispatches"],
             BATCH * engine.prefill_chunk: st["prefill_dispatches"]}
    check_launches(what, launches, mesh_launches(cfg, steps, engine.mesh))
    return dict(mesh=list(cfg.mesh_shape), backend=cfg.gemm_backend,
                dtype=cfg.compute_dtype,
                streams=[r.out_tokens for r in reqs], launches=launches,
                wall_s=wall, decode_step_ms=1e3 * st["decode_time_s"]
                / max(st["decode_dispatches"], 1),
                prefill_time_s=st["prefill_time_s"],
                prefill_chunk=engine.prefill_chunk,
                shard_cache=substrate.shard_cache_info()), engine


def _decode_logits(cfg, params, seed: int = 3):
    """One full-batch decode step of ``cfg`` on a fresh fp32 cache at
    position MAX_SEQ / 2, on the served tree."""
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, BATCH),
                           device="cuda")
    pos = torch.full((BATCH,), MAX_SEQ // 2, dtype=torch.int64,
                     device="cuda")
    cache = lm.init_cache(cfg, BATCH, MAX_SEQ, dtype=torch.float32)
    logits, _ = lm.decode_step(cfg, params, cache, toks, pos)
    torch.cuda.synchronize()
    return logits.float()


def _sharded_close(what, got, want, card):
    err = (got - want).abs().max().item()
    ok = bool(torch.allclose(got, want, **SHARDED_TOL))
    log(f"  {what}: max |sharded - unsharded| logit {err:.3g} "
        f"(rtol {SHARDED_TOL['rtol']}, atol {SHARDED_TOL['atol']}): "
        f"{'ok' if ok else 'FAIL'} (card: {card})")
    if not ok:
        raise AssertionError(f"{what}: sharded logits off by {err}")
    return err


def mesh_step_sites(cfg, params, mesh_shape):
    """The K1 / K2 launches of one decode step of ``cfg`` at
    ``mesh_shape`` (:func:`recorded_sites`: each shard's shape, flags and
    k), with their per-step counts."""
    c = dataclasses.replace(cfg, mesh_shape=mesh_shape)
    p = lm.prequantize_params(c, lm.prepare_params(c, params))
    cache = lm.init_cache(c, BATCH, MAX_SEQ)
    toks = torch.zeros(BATCH, dtype=torch.int64, device="cuda")
    pos = torch.full((BATCH,), MAX_SEQ // 2, dtype=torch.int64,
                     device="cuda")
    with recorded_sites(f"{cfg.name} {mesh_shape}") as sites:
        lm.decode_step(c, p, cache, toks, pos)
    torch.cuda.synchronize()
    return sites


def mesh_phase(cfg, params, serving, card: str):
    """Full-width ``cfg`` served by the ServingEngine over logical meshes
    of the one card (:data:`MESH_SHAPES`, four logical devices = four
    views of cuda:0): every shard of a sharded dispatch is its own K1 / K2
    launch at the shard's shapes, one after another.

    (a) bf16 on the three backends: every request ok, launches held to
    :func:`mesh_launches` (shards x per-site launches x steps), the streams
    recorded against phase 5's unsharded ones (a moved bf16 stream is
    reported, not failed: a row-parallel site adds fp32 partials where
    the unsharded kernel keeps one accumulator, and bf16 rounds after);
    (b) fp32 on ``arrayflex`` and ``arrayflex_int8``: streams equal the
    unsharded fp32 engine's; one decode step's logits within the
    reference's sharded tolerance of the unsharded step's; (c) the
    weight-block memo: its bytes, and a decode step's time with the memo
    cold (the copies) and warm; (d) every K1 / K2 launch of a tp 2 (and
    a (2, 2)) decode step checked against its plain version at the
    shard's shape and k with kernel_tol, the tp 2 ones timed (kernel,
    plain, library, bound); (e) one expert-parallel decode step of
    qwen3-moe-30b-a3b at tp 2 (4 layers) and one mamba2-370m decode step
    at tp 2, fp32, against their unsharded steps."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    out, runs, fp32_runs = {"serving": {}}, [], []
    t_phase = time.perf_counter()
    with mesh_lib.host_devices(4):
        for shape in MESH_SHAPES:
            for backend in BACKENDS:
                c = dataclasses.replace(cfg, gemm_backend=backend,
                                        mesh_shape=shape)
                run, engine = mesh_serving_run(c, params, prompts)
                colo = serving[backend]["streams"]
                run["streams_equal_unsharded"] = run["streams"] == colo
                run["first_divergence"] = _first_divergence(run["streams"],
                                                            colo)
                log(f"  (a) mesh {shape} {backend}/bf16: "
                    f"{run['decode_step_ms']:.2f} ms/decode step (unsharded "
                    f"{serving[backend]['decode_step_ms']:.2f}), streams "
                    f"equal unsharded {run['streams_equal_unsharded']} "
                    f"(first divergence {run['first_divergence']}); weight "
                    f"blocks {run['shard_cache']['bytes'] / 2**20:.1f} MiB; "
                    f"launches {({k: v for k, v in run['launches'].items() if v})} "
                    f"(card: {card})")
                out["serving"][f"{shape}/{backend}/bf16"] = run
                runs.append(run)
                del engine
                _free()
        for backend in ("arrayflex", "arrayflex_int8"):
            c32 = dataclasses.replace(cfg, gemm_backend=backend,
                                      compute_dtype="float32")
            colo = serving_run_fp32(c32, params, prompts)
            fp32_runs.append(colo["launches"])
            p32 = lm.prequantize_params(c32, lm.prepare_params(c32, params))
            want = _decode_logits(c32, p32)
            for shape in MESH_SHAPES:
                cm = dataclasses.replace(c32, mesh_shape=shape)
                run, engine = mesh_serving_run(cm, params, prompts)
                del engine
                fp32_runs.append(run["launches"])
                equal = run["streams"] == colo["streams"]
                run["streams_equal_unsharded"] = equal
                run["logit_err"] = _sharded_close(
                    f"(b) mesh {shape} {backend}/fp32 decode step", 
                    _decode_logits(cm, p32), want, card)
                log(f"  (b) mesh {shape} {backend}/fp32: streams equal the "
                    f"unsharded fp32 engine's: {equal} (card: {card})")
                if not equal:
                    raise AssertionError(
                        f"(b) mesh {shape} {backend}/fp32: streams differ "
                        f"from unsharded, first divergence "
                        f"{_first_divergence(run['streams'], colo['streams'])}")
                out["serving"][f"{shape}/{backend}/fp32"] = run
            del p32
            _free()
        out["memo"] = mesh_memo_cost(cfg, params, card)
        rows, errs = [], {}
        gen = torch.Generator(device="cuda").manual_seed(11)
        for backend in BACKENDS:
            c = dataclasses.replace(cfg, gemm_backend=backend)
            sites = mesh_step_sites(c, params, (1, MESH_TP))
            r, e = family_kernel_phase({f"decode tp2 {backend}": sites}, gen)
            rows += r
            for name, err in e.items():
                errs[name] = max(errs.get(name, 0.0), err)
            for site in mesh_step_sites(c, params, (2, 2)):
                for dt in (torch.bfloat16, torch.float32):
                    check_site(site, dt, gen, site.k)
        out["sites"] = rows
        out["max_err"] = errs
        for key, t in family_totals(rows).items():
            lib = t["library_ms"]
            log(f"  (d) tp {MESH_TP} decode step {key}: kernel {t['ms']:.3f} "
                f"/ plain {t['plain_ms']:.3f} / library "
                f"{'none' if lib is None else f'{lib:.3f}'} / bound "
                f"{t['bound_ms']:.4f} ms ({t['bound_by']}) (card: {card})")
        out["moe_ssm"] = mesh_moe_ssm(card)
        fp32_runs += [v.pop("launches") for v in out["moe_ssm"].values()]
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  mesh phase: {out['seconds']:.1f} s (card: {card})")
    out["runs"] = runs + [{"launches": v} for v in fp32_runs]
    return out


def mesh_memo_cost(cfg, params, card: str):
    """(c): a tp 2 bf16 decode step with the weight-block memo cleared
    (every column block copied contiguous, then kept) and the next steps
    with it warm, host clock around a synchronized step; the memo's
    blocks and bytes."""
    c = dataclasses.replace(cfg, mesh_shape=(1, MESH_TP))
    p = lm.prepare_params(c, params)
    cache = lm.init_cache(c, BATCH, MAX_SEQ)
    toks = torch.zeros(BATCH, dtype=torch.int64, device="cuda")
    pos = torch.full((BATCH,), MAX_SEQ // 2, dtype=torch.int64,
                     device="cuda")
    lm.decode_step(c, p, cache, toks, pos)       # plans, allocator
    times = []
    for i in range(6):
        if i == 0:
            substrate.clear_shard_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm.decode_step(c, p, cache, toks, pos)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    info = substrate.shard_cache_info()
    warm = sorted(times[1:])[len(times[1:]) // 2]
    log(f"  (c) weight-block memo at tp {MESH_TP}: {info['blocks']} blocks, "
        f"{info['bytes'] / 2**20:.1f} MiB held beside the tree; decode step "
        f"{times[0]:.2f} ms with the memo cold (copies) against "
        f"{warm:.2f} ms warm (median of 5) (card: {card})")
    del p, cache
    substrate.clear_shard_cache()
    _free()
    return dict(blocks=info["blocks"], bytes=info["bytes"],
                cold_step_ms=times[0], warm_step_ms=warm)


def mesh_moe_ssm(card: str):
    """(e): one decode step at tp 2 against the unsharded step, fp32
    compute on bf16 parameters: qwen3-moe-30b-a3b cut to
    MOE_PARITY_LAYERS layers (128 experts split 64 + 64: expert
    parallel) and full-width mamba2-370m (mamba.z / xbc / dt
    column-parallel, mamba.out row-parallel)."""
    out = {}
    for arch, layers in ((MOE_ARCH, MOE_PARITY_LAYERS), (SSM_ARCH, None)):
        c = dataclasses.replace(get_config(arch), gemm_backend="arrayflex",
                                compute_dtype="float32",
                                param_dtype="bfloat16")
        if layers:
            c = dataclasses.replace(c, n_layers=layers)
        p = lm.prepare_params(c, lm.init_params(c, seed=0))
        want = _decode_logits(c, p)
        cm = dataclasses.replace(c, mesh_shape=(1, MESH_TP))
        ag.reset_launches()                 # counts: 0 just before
        got = _decode_logits(cm, p)
        launches = dict(ag.LAUNCHES)        # read just after
        steps = {BATCH: 1}
        mesh = sharding.mesh_from_config(cm)
        want_l = mesh_launches(dataclasses.replace(
            cm, compute_dtype="float32"), steps, mesh)
        # the fresh fp32 cache: attn.pv multiplies fp32 operands (FFMA)
        want_l["arrayflex_expert_gemm_tc"] = 0
        check_launches(f"(e) {arch} tp {MESH_TP} decode step", launches,
                       want_l)
        out[arch] = dict(logit_err=_sharded_close(
            f"(e) {arch} x{c.n_layers} tp {MESH_TP} decode step", got, want,
            card), launches=launches)
        del p
        _free()
    return out


def pp_phase(cfg, params, serving, card: str):
    """The DisaggServingEngine with 2 + 2 pods at pp = 2, dense K/V, over
    four logical devices (two role windows of two stages), on the three
    backends with the prefill chunk pinned to the colocated one, and on
    ``arrayflex`` in fp32: a step's launches exactly the colocated
    step's (each stage runs once, no placeholder ticks), handoff bytes =
    handoffs x a row's, attn.wq launched at each role's k (the pinned
    role table: (colocated, prefill, decode) = (4, 4, 2) at 128 rows and
    (2, 2, 1) at 2048 on the 896 x 896 boundary site); streams equal
    phase 5's colocated streams bit for bit (fp32: the fp32 colocated
    engine's), but for W8A8 where a role re-picks attn.wq's k (its
    activation tiles follow k): there the first divergence is reported
    and two runs must agree."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    # the reference's table prices one epilogue op; the served attn.wq
    # also fuses the ln1 scale
    table_ep = substrate.Epilogue(kind="none", bias=True)
    wq_ep = substrate.Epilogue(kind="none", bias=cfg.qkv_bias,
                               norm_scale=True)

    def role_k(role, T, backend="arrayflex", ep=wq_ep):
        t_ops, t_cyc = sharding.pp_transfer_terms(role, PP, T, cfg.d_model)
        return substrate.plan_gemm(cfg.d_model, cfg.d_model, T, backend,
                                   ep, substrate.ShardSig(
                                       transfer_ops=t_ops,
                                       transfer_cycles=t_cyc)).k

    table = {T: tuple(role_k(r, T, ep=table_ep)
                      for r in ("", "prefill", "decode"))
             for T in (128, 2048)}
    if table != {128: (4, 4, 2), 2048: (2, 2, 1)}:
        raise AssertionError(f"the role table moved: {table}")
    out, runs = {"role_table": table}, []
    handoffs = sum(n > 1 for n in PROMPT_LENS)
    t_phase = time.perf_counter()

    def pp_run(bcfg, chunk):
        with recorded_sites(f"{cfg.name} pp{PP}") as sites:
            run, engine = disagg_run(bcfg, params, prompts, MAX_NEW,
                                     DisaggServeConfig(
                max_batch=BATCH, max_seq=MAX_SEQ, seed=0, prefill_pods=PP,
                decode_pods=PP, pp_stages=PP, prefill_chunk=chunk))
        if len(run["handoff_ms"]) != handoffs or engine.pp != PP:
            raise AssertionError(f"pp {bcfg.gemm_backend}: "
                                 f"{run['handoff_ms']}, pp {engine.pp}")
        del engine
        _free()
        ks = {}
        for st in sites:
            if st.name == sharding.PP_BOUNDARY_SITE:
                ks.setdefault(st.shape[0], set()).add(st.k)
        be = bcfg.gemm_backend
        want = {BATCH: {role_k("decode", BATCH, be)},
                BATCH * chunk: {role_k("prefill", BATCH * chunk, be)}}
        if ks != want:
            raise AssertionError(f"pp {be}: attn.wq launched at k {ks}, "
                                 f"the roles plan {want}")
        run["attn_wq_k"] = {str(r): sorted(k) for r, k in ks.items()}
        run["colocated_k"] = {str(r): role_k("", r, be) for r in ks}
        return run

    with mesh_lib.host_devices(2 * PP):
        for backend, colo in serving.items():
            bcfg = dataclasses.replace(cfg, gemm_backend=backend)
            run = pp_run(bcfg, colo["prefill_chunk"])
            _require_disagg(f"pp {backend}", run, None, transfer_retries=0,
                            kernel_fault_retries=0, sample_retries=0)
            run["streams_equal_colocated"] = run["streams"] == colo["streams"]
            run["first_divergence"] = _first_divergence(run["streams"],
                                                        colo["streams"])
            moved_k = any(run["attn_wq_k"][r] != [run["colocated_k"][r]]
                          for r in run["attn_wq_k"])
            if substrate.backend_act_quantizes(backend) and moved_k:
                # W8A8: the activation tiles span a k-wide main-loop step,
                # so a role that re-picks attn.wq's k quantizes other
                # tiles; the stream must repeat run to run
                again = pp_run(bcfg, colo["prefill_chunk"])
                if again["streams"] != run["streams"]:
                    raise AssertionError(f"pp {backend}: two runs differ")
                note = (f"streams equal colocated "
                        f"{run['streams_equal_colocated']} (first divergence "
                        f"{run['first_divergence']}: the roles re-pick "
                        f"attn.wq's k, W8A8's tile width), identical run to "
                        f"run")
            elif not run["streams_equal_colocated"]:
                raise AssertionError(
                    f"pp {backend}: streams differ from colocated, first "
                    f"divergence {run['first_divergence']}")
            else:
                note = "streams == colocated"
            _log_disagg(f"pp {PP} {backend}: {note}, attn.wq k by rows "
                        f"{run['attn_wq_k']} (colocated "
                        f"{run['colocated_k']}), kv_transfer_bytes "
                        f"{run['stats']['kv_transfer_bytes']} = {handoffs} x "
                        f"{run['row_bytes']} B", run, colo, card)
            out[backend] = run
            runs.append(run)
        c32 = dataclasses.replace(cfg, compute_dtype="float32")
        colo = serving_run_fp32(c32, params, prompts)
        run = pp_run(c32, colo["prefill_chunk"])
        _require_disagg("pp fp32", run, colo["streams"], transfer_retries=0,
                        kernel_fault_retries=0, sample_retries=0)
        log(f"  pp {PP} arrayflex/fp32: streams == the fp32 colocated "
            f"engine's, attn.wq k by rows {run['attn_wq_k']} (card: {card})")
        out["fp32"] = run
        runs += [run, {"launches": colo["launches"]}]
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  pp phase: {out['seconds']:.1f} s (card: {card})")
    out["runs"] = runs
    return out

# ---------------------------------------------------------------------------
# phase 6: full-sequence prefill

# prompt lengths of the full-sequence prefill (B = 1): the last one at or
# below qwen2-0.5b's attn_dense_below (dense attention), and one above it
# (the chunked scan)
FWD_SEQS = (2048, 4096)


def forward_seq(cfg, S: int, n_ctx: int = 0):
    """(site, query rows) of every dispatch of one ``lm.prefill`` of
    ``cfg`` at B = 1, S tokens and a context of ``n_ctx`` rows: the VLM's
    ``frontend.img``, or the audio encoder (``frontend.audio``, then each
    encoder layer's attention and MLP over the frames), then
    :func:`step_sites` over the full sequence."""
    seq = []
    if cfg.family == "vlm":
        seq.append(("frontend.img", n_ctx))
    if cfg.family == "audio":
        seq.append(("frontend.audio", n_ctx))
        seq += [(s, n_ctx) for _ in range(cfg.n_encoder_layers)
                for s in ATTN_SITES + MLP_SITES]
    return seq + [(s, S) for s in step_sites(cfg, full=True)]


def forward_launches(cfg, S: int, n_ctx: int = 0):
    """Kernel launches of one ``lm.prefill`` of ``cfg`` on ``arrayflex``
    (:func:`forward_seq`): every weight GEMM on K1, the MoE router on the
    fp32 K1 and the expert banks on K2, and attn.qk / attn.pv on K2 where
    their query rows take the dense attention path (the chunked scan above
    ``attn_dense_below`` dispatches nothing).  K3 is never on the model
    path."""
    want = {name: 0 for name in list(ag.LAUNCHES) + list(fa.LAUNCHES)}
    for site, rows in forward_seq(cfg, S, n_ctx):
        if site in ("attn.qk", "attn.pv") and rows > cfg.attn_dense_below:
            continue
        for name, n in site_launches(cfg, site).items():
            want[name] += n
    return want


def prefill_sites(cfg, S: int):
    """The GEMM sites of one full-sequence ``lm.prefill`` of ``cfg`` at
    B = 1 and S tokens: every weight GEMM at S rows, the unembed of all S
    positions (fp32 logits, as the reference's ``prefill`` computes them
    before it keeps the last), and on the dense attention path attn.qk /
    attn.pv with each KV head's g * S query rows against S keys.  Two
    weight copies rotate: at S rows the products, not the weight bytes,
    set the time."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    L, V, ff, g = cfg.n_layers, cfg.padded_vocab, cfg.d_ff, H // KV
    qkv = dict(bias=cfg.qkv_bias, norm_scale=True)
    kw = dict(copies=2, cell=cfg.name)
    sites = [
        Site("attn.wq", "arrayflex_gemm", (S, d, H * hd), L, qkv, **kw),
        Site("attn.wk", "arrayflex_gemm", (S, d, KV * hd), L, qkv, **kw),
        Site("attn.wv", "arrayflex_gemm", (S, d, KV * hd), L, qkv, **kw),
        Site("attn.wo", "arrayflex_gemm", (S, H * hd, d), L, **kw),
        Site("mlp.wi_gate+mlp.wi_up", "arrayflex_gemm", (S, d, ff), L,
             dict(dual=True, activation="silu", norm_scale=True), **kw),
        Site("mlp.wo", "arrayflex_gemm", (S, ff, d), L, dict(residual=True),
             **kw),
        Site("unembed", "arrayflex_gemm", (S, d, V), 1,
             dict(out_f32=True) if cfg.tie_embeddings else {}, copies=1,
             cell=cfg.name),
    ]
    if S <= cfg.attn_dense_below:
        sites += [
            Site("attn.qk", "arrayflex_expert_gemm", (KV, g * S, hd, S), L,
                 dict(out_f32=True), **kw),
            Site("attn.pv", "arrayflex_expert_gemm", (KV, g * S, S, hd), L,
                 **kw),
        ]
    return sites


def prefill_kernel_phase(cfg):
    """K1 and K2 at the full-sequence prefill's site shapes (each of
    FWD_SEQS): checked against the plain version in bf16 and fp32 at k in
    {1, 2, 4}, then timed in bf16 at the planned k like the decode sites.
    Returns the rows and the per-prefill totals per form."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows, totals = [], {}
    for S in FWD_SEQS:
        for site in prefill_sites(cfg, S):
            errs = {f"{dt}".split(".")[-1] + f"/k{k}": check_site(
                site, dt, gen, k, step_tol)
                for dt in (torch.bfloat16, torch.float32) for k in (1, 2, 4)}
            t = time_site(site, gen, 2 if site.name == "unembed" else 4)
            _free()
            row = dict(phase=f"prefill S={S}", cell=site.cell,
                       site=site.name, kernel=site.kernel, form=site.form,
                       launch_name=site.kernel_key(site.time_dtype),
                       shape=site.shape,
                       per_step=site.per_step, max_abs_err=errs, **t)
            rows.append(row)
            log(f"  S={S} {site.name:22s} {str(site.shape):26s} k={t['k']} "
                f"kernel {_us(t['ms'])} us  plain {_us(t['plain_ms'])} us  "
                f"library {_us(t['library_ms'])} us  bound "
                f"{t['bound_ms'] * 1e3:8.2f} us ({t['bound_by']})")
        for name in ("arrayflex_gemm_tc", "arrayflex_expert_gemm_tc"):
            sel = [r for r in rows if r["phase"] == f"prefill S={S}"
                   and r["launch_name"] == name]
            if sel:
                tot = _step_totals(sel)
                totals[f"S={S} {name}"] = tot
                log(f"  S={S} {name}: kernel {tot['ms']:.3f} / plain "
                    f"{tot['plain_ms']:.3f} / library {tot['library_ms']:.3f}"
                    f" / bound {tot['bound_ms']:.4f} ms per prefill "
                    f"({tot['bound_by']})")
    return rows, totals


def forward_phase(cfg, params, seqs=FWD_SEQS):
    """Full-width ``lm.prefill`` at each of ``seqs`` (B = 1, the served
    bf16 tree): host-clock time of the run whose counters are checked,
    device busy time of another (profiler), peak memory, logits and cache
    shapes and dtypes (``lm.init_cache``'s at S)."""
    served = lm.prepare_params(cfg, params)
    rng = np.random.default_rng(4)
    out = {}
    for S in seqs:
        batch = {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (1, S)), device="cuda")}
        lm.prefill(cfg, served, batch)           # warm-up
        _free()
        torch.cuda.reset_peak_memory_stats()
        ag.reset_launches()                     # counts: 0 just before the run
        fa.reset_launches()
        t0 = time.perf_counter()
        logits, caches = lm.prefill(cfg, served, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(ag.LAUNCHES, **fa.LAUNCHES)   # read just after
        peak = torch.cuda.max_memory_allocated()
        check_launches(f"{cfg.name} prefill S={S}", launches,
                       forward_launches(cfg, S))

        def leaves(caches):
            return [(tuple(t.shape), t.dtype) for c in caches
                    for t in c.values()]
        if (tuple(logits.shape) != (1, cfg.padded_vocab)
                or not bool(torch.isfinite(logits).all())
                or leaves(caches) != leaves(lm.init_cache(cfg, 1, S))):
            raise AssertionError(f"prefill S={S}: logits "
                                 f"{tuple(logits.shape)} or caches wrong, "
                                 f"or non-finite logits")
        del logits, caches
        path = ("the SSD scan" if cfg.family == "ssm" else
                "dense attention" if S <= cfg.attn_dense_below
                else "chunked attention")
        log(f"  {cfg.name} x{cfg.n_layers} lm.prefill B=1 S={S} ({path}"
            f"): {wall_ms:.1f} ms host clock, peak "
            f"{peak / 2**30:.2f} GiB; launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        prof = profile_device(lambda: lm.prefill(cfg, served, batch),
                              wall_ms, f"prefill of {S} tokens")
        out[S] = dict(S=S, attention=path, prefill_ms=wall_ms,
                      max_memory_allocated_bytes=peak, launches=launches,
                      profile=prof)
        _free()
    del served
    _free()
    return out


# ---------------------------------------------------------------------------
# phase 7: model parity on the card

def parity_phase(cfg, params):
    out = {}
    B, C = 2, 32
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, C)),
                           device="cuda")
    lens = torch.tensor([C, C - 5], device="cuda")
    pos0 = torch.zeros(B, dtype=torch.int64, device="cuda")
    nxt = torch.as_tensor(rng.integers(0, cfg.vocab_size, B), device="cuda")
    for dt_name, dt in (("bfloat16", torch.bfloat16),
                        ("float32", torch.float32)):
        logits = {}
        for backend in ("arrayflex", "ref"):
            c = dataclasses.replace(cfg, gemm_backend=backend,
                                    compute_dtype=dt_name)
            p = lm.prepare_params(c, params)
            cache = lm.init_cache(c, B, 64, dtype=dt)
            lp, cache = lm.prefill_step(c, p, cache, toks, pos0, lens)
            ld, _ = lm.decode_step(c, p, cache, nxt, lens)
            logits[backend] = torch.cat([lp, ld]).float()
            del p, cache
        ref = logits["ref"]
        if not bool(torch.isfinite(logits["arrayflex"]).all()):
            raise AssertionError(f"{dt_name}: non-finite kernel logits")
        err = (logits["arrayflex"] - ref).abs().max().item()
        scale = ref.abs().max().item()
        tol = MODEL_TOL[dt] * scale
        log(f"  {dt_name}: max |logit diff| {err:.4g} (max |logit| "
            f"{scale:.4g}, tol {tol:.4g})")
        if not err <= tol:
            raise AssertionError(f"{dt_name} model parity: {err} > {tol}")
        out[dt_name] = dict(max_abs_err=err, max_abs_logit=scale, tol=tol)
    return out


def _dequantized(tree):
    """The tree with each int8 leaf replaced by ``codes.float() * scale``
    (``table_q`` becomes the float ``table_t`` unembed reads)."""
    if isinstance(tree, dict):
        return {("table_t" if k == "table_q" else k): _dequantized(v)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_dequantized(v) for v in tree)
    if isinstance(tree, substrate.QuantizedTensor):
        return tree.codes.float() * tree.scale.unsqueeze(-2)
    return tree


def quant_parity_phase(cfg, params):
    """fp32 logits of one prefill_step + decode_step: arrayflex_int8 vs ref
    on the dequantized weights (W8_PARITY_TOL), and arrayflex_w8a8 vs fp32
    arrayflex (W8A8_PARITY_TOL), relative to max |reference logit|.  The
    arrayflex_int8 run is the fp32 W8 path: its launch counters, set to 0
    just before it and read just after, must show every W8 K1 launch on
    the FFMA kernel (returned under ``launches``)."""
    B, C = 2, 32
    rng = np.random.default_rng(2)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, C)),
                           device="cuda")
    lens = torch.tensor([C, C - 5], device="cuda")
    pos0 = torch.zeros(B, dtype=torch.int64, device="cuda")
    nxt = torch.as_tensor(rng.integers(0, cfg.vocab_size, B), device="cuda")

    def quantized(c):
        return lm.prequantize_params(c, lm.prepare_params(c, params))

    out = {"launches": {}}

    def logits(backend, tree_of):
        c = dataclasses.replace(cfg, gemm_backend=backend,
                                compute_dtype="float32")
        p = tree_of(c)
        cache = lm.init_cache(c, B, 64, dtype=torch.float32)
        torch.cuda.synchronize()
        ag.reset_launches()                     # counts: 0 just before
        lp, cache = lm.prefill_step(c, p, cache, toks, pos0, lens)
        ld, _ = lm.decode_step(c, p, cache, nxt, lens)
        torch.cuda.synchronize()
        if backend == "arrayflex_int8":
            launches = dict(ag.LAUNCHES)        # read just after
            check_fp32_w8_launches(f"fp32 {cfg.name} arrayflex_int8",
                                   launches)
            out["launches"][cfg.name] = launches
        res = torch.cat([lp, ld]).float()
        if not bool(torch.isfinite(res).all()):
            raise AssertionError(f"{backend}: non-finite logits")
        return res

    for name, (got, want), tol in (
            ("arrayflex_int8 vs ref(dequantized)",
             (logits("arrayflex_int8", quantized),
              logits("ref", lambda c: _dequantized(quantized(
                  dataclasses.replace(c, gemm_backend="arrayflex_int8"))))),
             W8_PARITY_TOL),
            ("arrayflex_w8a8 vs arrayflex",
             (logits("arrayflex_w8a8", quantized),
              logits("arrayflex", lambda c: lm.prepare_params(c, params))),
             W8A8_PARITY_TOL)):
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        log(f"  {name} (fp32): max |logit diff| {err:.4g} = "
            f"{err / scale:.3g} of max |logit| {scale:.4g} (tol {tol:.3g})")
        if not err <= tol * scale:
            raise AssertionError(f"{name} parity: {err} > {tol * scale}")
        out[name] = dict(max_abs_err=err, max_abs_logit=scale,
                         rel_err=err / scale, rel_tol=tol)
    return out


def forward_parity_phase(cfg, params):
    """fp32 last-token logits of full-width ``lm.prefill`` at each of
    FWD_SEQS (B = 1): on the kernels against the ``ref`` backend, and
    against the engine's path on the same tokens — ``prefill_step`` over
    the engine's planner-picked chunks into an fp32 cache — each within
    MODEL_TOL of max |reference logit|.  The kernels' run is the fp32
    path: its launch counters, set to 0 just before it and read just
    after, must show every K1 and K2 launch on the FFMA kernels
    (returned under ``launches``)."""
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    rng = np.random.default_rng(5)
    out = {"launches": {}}
    for S in FWD_SEQS:
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, S)),
                               device="cuda")
        logits = {}
        for backend in ("arrayflex", "ref"):
            c = dataclasses.replace(c32, gemm_backend=backend)
            params_c = lm.prepare_params(c, params)
            torch.cuda.synchronize()
            ag.reset_launches()                 # counts: 0 just before
            fa.reset_launches()
            logits[backend], _ = lm.prefill(c, params_c, {"tokens": toks})
            torch.cuda.synchronize()
            if backend == "arrayflex":
                launches = dict(ag.LAUNCHES, **fa.LAUNCHES)  # just after
                check_launches(f"fp32 prefill S={S}", launches,
                               forward_launches(c, S))
                out["launches"][S] = launches
            del params_c
            _free()
        c = dataclasses.replace(c32, gemm_backend="arrayflex")
        p = lm.prepare_params(c, params)
        chunk = min(S, planner.attention_plan(S, S,
                                              choices=PREFILL_CHUNK_CHOICES))
        cache = lm.init_cache(c, 1, S, dtype=torch.float32)
        for c0 in range(0, S, chunk):
            n = min(chunk, S - c0)
            logits["prefill_step"], cache = lm.prefill_step(
                c, p, cache, toks[:, c0:c0 + n],
                torch.tensor([c0], device="cuda"),
                torch.tensor([n], device="cuda"))
        del p, cache
        _free()
        if not all(bool(torch.isfinite(v).all()) for v in logits.values()):
            raise AssertionError(f"prefill S={S}: non-finite logits")
        for got, want in (("arrayflex", "ref"),
                          ("arrayflex", "prefill_step")):
            err = (logits[got] - logits[want]).abs().max().item()
            scale = logits[want].abs().max().item()
            tol = MODEL_TOL[torch.float32] * scale
            name = f"prefill S={S} {got} vs {want}"
            log(f"  {cfg.name} x{cfg.n_layers} {name} (fp32{f', chunk {chunk}' if want == 'prefill_step' else ''}): "
                f"max |logit diff| {err:.4g} = {err / scale:.3g} of max "
                f"|logit| {scale:.4g} (tol {MODEL_TOL[torch.float32]:.3g})")
            if not err <= tol:
                raise AssertionError(f"{name} parity: {err} > {tol}")
            out[name] = dict(max_abs_err=err, max_abs_logit=scale,
                             rel_err=err / scale,
                             rel_tol=MODEL_TOL[torch.float32])
        del logits
        _free()
    return out


def moe_prefill_parity(cfg, params):
    """fp32 last-token logits of ``lm.prefill`` (B = 1, S = MOE_FWD_SEQ,
    dense attention with head_dim 128, one routing group per sequence) on
    the kernels against ``ref``, with the routing of every layer and the
    aux loss compared."""
    toks = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (1, MOE_FWD_SEQ)), device="cuda")
    runs = {}
    for backend in ("arrayflex", "ref"):
        c = dataclasses.replace(cfg, gemm_backend=backend)
        with moe.record_routing() as routing:
            logits, aux, _ = lm.forward(c, lm.prepare_params(c, params),
                                        {"tokens": toks})
        runs[backend] = (logits[:, -1], float(aux),
                         [idx for idx, _ in routing])
        del logits
        _free()
    (a, aux_a, ra), (b, aux_b, rb) = runs["arrayflex"], runs["ref"]
    if not bool(torch.isfinite(a).all()):
        raise AssertionError("MoE prefill: non-finite logits")
    err = (a - b).abs().max().item()
    scale = b.abs().max().item()
    same = all(torch.equal(x, y) for x, y in zip(ra, rb))
    tol = MODEL_TOL[torch.float32]
    log(f"  {cfg.name} x{cfg.n_layers} lm.prefill S={MOE_FWD_SEQ} arrayflex "
        f"vs ref (fp32): max |logit diff| {err:.4g} = {err / scale:.3g} of "
        f"max |logit| {scale:.4g} (tol {tol:.3g}); aux {aux_a:.6g} vs "
        f"{aux_b:.6g}; same top-{cfg.moe.top_k} experts at all {len(ra)} "
        f"layers: {same}")
    if not err <= tol * scale:
        raise AssertionError(f"MoE prefill parity: {err} > {tol * scale}")
    return dict(max_abs_err=err, max_abs_logit=scale, rel_err=err / scale,
                rel_tol=tol, aux=aux_a, ref_aux=aux_b, same_experts=same)


def moe_parity_phase(moe_cfg):
    """fp32 logits of ``MOE_PARITY_STEPS`` decode steps (batch 2, fp32 K/V
    cache) of full-width qwen3-moe-30b-a3b cut to 4 layers: arrayflex vs
    ref (MODEL_TOL), arrayflex_int8 vs ref on the dequantized weights
    (W8_PARITY_TOL), arrayflex_w8a8 vs fp32 arrayflex
    (W8A8_MOE_PARITY_TOL), each relative to max |reference logit|; and
    for each pair whether both runs picked the same top-k experts for
    every token at every layer and step.  The arrayflex_int8 run's launch
    counters (0 just before, read just after) must show every W8 K1
    launch on the FFMA kernel (returned under ``launches``)."""
    cfg = dataclasses.replace(moe_cfg, n_layers=MOE_PARITY_LAYERS,
                              param_dtype="float32", compute_dtype="float32")
    params = lm.init_params(cfg, seed=0)
    B, steps = 2, MOE_PARITY_STEPS
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (steps, B)),
                           device="cuda")

    def quantized(c):
        return lm.prequantize_params(c, lm.prepare_params(c, params))

    w8_launches = {}

    def run(backend, tree_of):
        c = dataclasses.replace(cfg, gemm_backend=backend)
        p = tree_of(c)
        cache = lm.init_cache(c, B, 16, dtype=torch.float32)
        logits = []
        torch.cuda.synchronize()
        ag.reset_launches()                     # counts: 0 just before
        with moe.record_routing() as routing:
            for t in range(steps):
                pos = torch.full((B,), t, dtype=torch.int64, device="cuda")
                lg, cache = lm.decode_step(c, p, cache, toks[t], pos)
                logits.append(lg.float())
        torch.cuda.synchronize()
        if backend == "arrayflex_int8":
            w8_launches[cfg.name] = dict(ag.LAUNCHES)   # read just after
            check_fp32_w8_launches(f"fp32 {cfg.name} arrayflex_int8",
                                   w8_launches[cfg.name])
        out = torch.cat(logits)
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{backend}: non-finite logits")
        del p, cache
        _free()
        return out, [idx for idx, _ in routing]

    prefill = moe_prefill_parity(cfg, params)
    runs = {
        "arrayflex": run("arrayflex", lambda c: lm.prepare_params(c, params)),
        "ref": run("ref", lambda c: lm.prepare_params(c, params)),
        "arrayflex_int8": run("arrayflex_int8", quantized),
        "ref(dequantized)": run("ref", lambda c: _dequantized(quantized(
            dataclasses.replace(c, gemm_backend="arrayflex_int8")))),
        "arrayflex_w8a8": run("arrayflex_w8a8", quantized),
    }
    del params
    _free()
    out = {}
    for got, want, tol in (("arrayflex", "ref", MODEL_TOL[torch.float32]),
                           ("arrayflex_int8", "ref(dequantized)",
                            W8_PARITY_TOL),
                           ("arrayflex_w8a8", "arrayflex",
                            W8A8_MOE_PARITY_TOL)):
        (a, ra), (b, rb) = runs[got], runs[want]
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        same = all(torch.equal(x, y) for x, y in zip(ra, rb))
        name = f"{got} vs {want}"
        log(f"  {cfg.name} x{cfg.n_layers} {name} (fp32, {steps} decode "
            f"steps): max |logit diff| {err:.4g} = {err / scale:.3g} of max "
            f"|logit| {scale:.4g} (tol {tol:.3g}); same top-{cfg.moe.top_k} "
            f"experts at all {len(ra)} layer-steps: {same}")
        if not err <= tol * scale:
            raise AssertionError(f"{name} parity: {err} > {tol * scale}")
        out[name] = dict(max_abs_err=err, max_abs_logit=scale,
                         rel_err=err / scale, rel_tol=tol,
                         same_experts=same)
    out[f"prefill S={MOE_FWD_SEQ} arrayflex vs ref"] = prefill
    out["launches"] = w8_launches
    return out


# ---------------------------------------------------------------------------
# the SSM cell (full-width mamba2-370m) and the hybrid interleave: serving
# (phase 5), the full-sequence prefill (phase 6) and parity (phase 7)

@contextlib.contextmanager
def every_dispatch_draws():
    """Inside, every GEMM dispatch of a step attempt draws the
    ``substrate.dispatch`` chaos point (the engine's trace scope, where
    each site label draws at its first dispatch in each sub-layer position
    of the period only, is replaced by no scope), so an injected fault can
    land at any layer."""
    saved = substrate.chaos_trace_scope
    substrate.chaos_trace_scope = contextlib.nullcontext
    try:
        yield
    finally:
        substrate.chaos_trace_scope = saved


def state_commit_ms(engine, iters: int = 20) -> dict:
    """Stream time (CUDA events around ``iters`` runs, issued from the
    host) of the two ways a retry could be made safe that the decode step
    does not take: ``copy_ms``, every layer's new ``state`` and ``conv``
    copied into fresh stacked tensors after the recurrence (the step
    instead has the recurrence write its result there: no copy kernel),
    and ``save_ms``, a whole copy of the recurrent leaves before each
    attempt, to put back before a retry."""
    leaves = [t for c in engine.cache for k, t in c.items()
              if k in ("state", "conv")]
    layers_ = [[t[l].clone() for l in range(t.shape[0])] for t in leaves]

    def copy():
        for t, per_layer in zip(leaves, layers_):
            new = torch.empty_like(t)
            for l, x in enumerate(per_layer):
                new[l] = x

    def save():
        for t in leaves:
            t.clone()

    out = {}
    for name, fn in (("copy", copy), ("save", save)):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        out[f"{name}_ms"] = start.elapsed_time(end) / iters
    out["bytes"] = sum(t.numel() * t.element_size() for t in leaves)
    return out


def ssm_serving_phase(ssm_cfg):
    """Full-width mamba2-370m (bf16 parameters, seed 0) served on the three
    backends (:func:`serving_phase`: token prefill, launches per step from
    :func:`step_sites` — 48 x 4 mamba sites and the unembed on K1, no K2 or
    K3 — every request ``ok``, the decode step's host-clock and
    device-busy time, peak memory), then one resilient run on
    ``arrayflex``: a GEMM fault at the last layer's mamba.out in the first
    step of the decode path (the first token-prefill step; every dispatch
    draws) and a NaN at the first sampling, each retried: streams equal to
    the clean run's.  Returns (results, the runs whose launches count,
    params)."""
    cfg = ssm_cfg
    params = lm.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _tensors(params))
    log(f"  {cfg.name} x{cfg.n_layers}: {n_bytes / 1e9:.3f} GB of bf16 "
        f"parameters")
    out = {}
    for backend in ("arrayflex", "arrayflex_int8", "arrayflex_w8a8"):
        bcfg = dataclasses.replace(cfg, gemm_backend=backend)
        out[backend] = serving_phase(bcfg, params, SSM_PROMPT_LENS,
                                     SSM_MAX_NEW, SSM_MAX_SEQ)
        out[backend]["param_bytes"] = n_bytes
        per_step = {k: v for k, v in expected_launches(bcfg, 1).items() if v}
        log(f"  launches per step {per_step}")
        _free()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in SSM_PROMPT_LENS]
    seq = step_sites(cfg)
    n = len(seq) - 1 - seq[::-1].index("mamba.out")
    sc = ServeConfig(max_batch=BATCH, max_seq=SSM_MAX_SEQ, seed=0,
                     chaos=ChaosConfig(gemm_fault_at=n, nan_logits_at=0))
    with every_dispatch_draws():
        run, engine = resilient_run(cfg, params, prompts, SSM_MAX_NEW, sc,
                                    per_dispatch=True)
    _require(f"{cfg.name} retried fault at dispatch {n} and NaN", run,
             out["arrayflex"]["streams"], kernel_fault_retries=1,
             sample_retries=1)
    if run["chaos_log"][0] != ("substrate.dispatch", n, "mamba.out"):
        raise AssertionError(f"chaos log {run['chaos_log']}")
    run["commit"] = state_commit_ms(engine)
    run["kv_cache_bytes"] = engine.kv_cache_bytes()
    out["resilience"] = run
    c = run["commit"]
    log(f"  resilient run: fault at dispatch {n} (layer {cfg.n_layers - 1}'s"
        f" mamba.out) of the first token-prefill step and a NaN at the "
        f"first sampling, each retried: streams equal the clean run's; "
        f"chaos log {run['chaos_log']}")
    log(f"  the step writes its {c['bytes']} B of recurrent leaves into "
        f"fresh tensors from the recurrence itself; per-layer copies there "
        f"would take {c['copy_ms']:.4f} ms of stream time, a save of the "
        f"leaves before each attempt {c['save_ms']:.4f} ms")
    del engine
    _free()
    runs = [out[b] for b in ("arrayflex", "arrayflex_int8",
                             "arrayflex_w8a8")] + [run]
    return out, runs, params


def _rel(what, got, want, tol):
    """max |got - want| against ``tol`` of max |want|; raises beyond."""
    if not (bool(torch.isfinite(got).all())
            and bool(torch.isfinite(want).all())):
        raise AssertionError(f"{what}: non-finite logits")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    log(f"  {what}: max |logit diff| {err:.4g} = {err / scale:.3g} of max "
        f"|logit| {scale:.4g} (tol {tol:.3g})")
    if not err <= tol * scale:
        raise AssertionError(f"{what}: {err} > {tol * scale}")
    return dict(max_abs_err=err, max_abs_logit=scale, rel_err=err / scale,
                rel_tol=tol)


def _counted(what, c, fn):
    """``fn()`` with the launch counters set to 0 just before and read
    just after: an fp32 run, so every launch must be on the FFMA kernels.
    Returns (fn's result, the launches)."""
    torch.cuda.synchronize()
    ag.reset_launches()
    fa.reset_launches()
    res = fn()
    torch.cuda.synchronize()
    launches = dict(ag.LAUNCHES)
    if any(launches[name] for name in TC_COUNTERS) or \
            fa.LAUNCHES["flash_attention"]:
        raise AssertionError(f"{what}: fp32 launches {launches} reached a "
                             f"tensor-core kernel or K3")
    return res, launches


def ssm_parity_phase(cfg, params):
    """fp32 on the card, full-width mamba2-370m (the bf16 tree in fp32):
    (a) SSM_PARITY_STEPS decode steps (batch 2, an fp32 cache) and (b)
    ``lm.prefill`` at S = SSM_FWD_SEQ on the kernels against ``ref``
    within MODEL_TOL, each kernels' run counted (launches per step / per
    prefill, all on the FFMA K1); (c) the max_batch=1 anchor: one request
    alone served on ``arrayflex`` in fp32 with the bf16 conv window as
    served, its stream the argmax of its decode-by-decode logits, whose
    gap to ``lm.forward``'s logits at every position must be within the
    same gap of the ``ref`` backend plus BF16_WINDOW_TOL of the logit
    scale (the two differ in fp32 rounding, and the window flips it can
    cause).  Returns (results, the counted launches)."""
    # the bf16 tree in fp32 compute: every leaf is cast to fp32 (or read
    # as fp32) where it is used, so no fp32 copy of the tree is needed
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    B = 2
    rng = np.random.default_rng(8)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (SSM_PARITY_STEPS, B)), device="cuda")
    out, counted = {}, []

    def decode(c, p):
        cache = lm.init_cache(c, B, 16, dtype=torch.float32)
        logits = []
        for t in range(SSM_PARITY_STEPS):
            pos = torch.full((B,), t, dtype=torch.int64, device="cuda")
            lg, cache = lm.decode_step(c, p, cache, toks[t], pos)
            logits.append(lg.float())
        return torch.cat(logits)

    fwd = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (1, SSM_FWD_SEQ)), device="cuda")}
    runs = {}
    for backend in ("arrayflex", "ref"):
        c = dataclasses.replace(c32, gemm_backend=backend)
        p = lm.prepare_params(c, params)
        if backend == "arrayflex":
            runs[backend, "decode"], n = _counted(
                "fp32 mamba2 decode", c, lambda: decode(c, p))
            if n != expected_launches(c, SSM_PARITY_STEPS):
                raise AssertionError(f"fp32 mamba2 decode launches {n}")
            counted.append(n)
            (runs[backend, "prefill"], _), n = _counted(
                "fp32 mamba2 prefill", c, lambda: lm.prefill(c, p, fwd))
            check_launches(f"fp32 {cfg.name} prefill", dict(n, **fa.LAUNCHES),
                           forward_launches(c, SSM_FWD_SEQ))
            counted.append(n)
        else:
            runs[backend, "decode"] = decode(c, p)
            runs[backend, "prefill"], _ = lm.prefill(c, p, fwd)
        del p
        _free()
    for what, shape in (("decode", f"{SSM_PARITY_STEPS} steps"),
                        ("prefill", f"S={SSM_FWD_SEQ}")):
        out[f"{what} arrayflex vs ref"] = _rel(
            f"{cfg.name} x{cfg.n_layers} {what} arrayflex vs ref (fp32, "
            f"{shape})", runs["arrayflex", what], runs["ref", what],
            MODEL_TOL[torch.float32])
    del runs
    _free()
    out["anchor"] = ssm_anchor(c32, params)
    return out, counted


def ssm_anchor(c32, params):
    """The max_batch=1 anchor of :func:`ssm_parity_phase` (c)."""
    prompt = np.random.default_rng(9).integers(
        0, c32.vocab_size, 16).tolist()
    new = 8
    c = dataclasses.replace(c32, gemm_backend="arrayflex")
    engine = ServingEngine(c, params, ServeConfig(max_batch=1,
                                               max_seq=SSM_MAX_SEQ, seed=0))
    req = Request(prompt=prompt, max_new_tokens=new)
    engine.submit(req)
    engine.run_to_completion()
    check_clean(f"{c.name} one request alone", engine, [req])
    del engine
    _free()
    toks = prompt + req.out_tokens[:-1]
    out = dict(stream=req.out_tokens)
    for backend in ("arrayflex", "ref"):
        cb = dataclasses.replace(c32, gemm_backend=backend)
        p = lm.prepare_params(cb, params)
        full, _, _ = lm.forward(cb, p, {"tokens": torch.tensor(
            [toks], device="cuda")})
        cache = lm.init_cache(cb, 1, SSM_MAX_SEQ)        # bf16 window
        steps = []
        for t, tok in enumerate(toks):
            lg, cache = lm.decode_step(cb, p, cache,
                                       torch.tensor([tok], device="cuda"),
                                       torch.tensor([t], device="cuda"))
            steps.append(lg[0].float())
        steps = torch.stack(steps)
        out[backend] = dict(
            gap=(steps - full[0]).abs().max().item(),
            scale=full[0].abs().max().item(),
            decode_argmax=steps[len(prompt) - 1:].argmax(-1).tolist(),
            forward_argmax=full[0, len(prompt) - 1:].argmax(-1).tolist())
        del p, full, cache
        _free()
    af, ref = out["arrayflex"], out["ref"]
    tol = ref["gap"] + BF16_WINDOW_TOL * max(1.0, ref["scale"])
    log(f"  {c32.name} one request alone (max_batch=1, fp32, bf16 conv "
        f"window): decode-by-decode vs lm.forward logits gap "
        f"{af['gap']:.4g} on the kernels, {ref['gap']:.4g} on ref (max "
        f"|logit| {ref['scale']:.4g}; tol {tol:.4g}); stream {req.out_tokens}"
        f"; the forward's argmax gives it: "
        f"{af['forward_argmax'] == req.out_tokens}")
    if af["decode_argmax"] != req.out_tokens or not af["gap"] <= tol:
        raise AssertionError(f"anchor: {out}")
    return out


def hybrid_parity_phase():
    """Reduced jamba-1.5-large-398b (the hybrid interleave: period 8, one
    attention sub-layer, the MoE on odd sub-layers) in fp32 on the card,
    seed 0: HYBRID_STEPS decode steps (batch 2, an fp32 cache) and one
    ``lm.forward`` of HYBRID_FWD_SEQ tokens on the kernels against
    ``ref`` within MODEL_TOL, with whether both routed every token to the
    same experts; the kernels' decode run counted: K1 at the mamba,
    attention-projection, MLP, router and unembed sites, K2 at attn.qk /
    attn.pv and the expert banks, launches per step from
    :func:`step_sites`, all on the FFMA kernels.  Returns (results, the
    counted launches)."""
    cfg = dataclasses.replace(reduced(get_config(HYBRID_ARCH)),
                              compute_dtype="float32")
    params = lm.init_params(cfg, seed=0)
    B = 2
    rng = np.random.default_rng(10)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (HYBRID_STEPS, B)), device="cuda")
    fwd = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (1, HYBRID_FWD_SEQ)), device="cuda")}
    runs, counted = {}, None
    for backend in ("arrayflex", "ref"):
        c = dataclasses.replace(cfg, gemm_backend=backend)
        p = lm.prepare_params(c, params)

        def decode():
            cache = lm.init_cache(c, B, 16, dtype=torch.float32)
            logits = []
            for t in range(HYBRID_STEPS):
                pos = torch.full((B,), t, dtype=torch.int64, device="cuda")
                lg, cache = lm.decode_step(c, p, cache, toks[t], pos)
                logits.append(lg.float())
            return torch.cat(logits)

        with moe.record_routing() as routing:
            if backend == "arrayflex":
                logits, counted = _counted("fp32 hybrid decode", c, decode)
                want = expected_launches(c, HYBRID_STEPS)
                if counted != want:
                    raise AssertionError(f"hybrid decode launches {counted}"
                                         f" != {want}")
            else:
                logits = decode()
            full, _, _ = lm.forward(c, p, fwd)
        runs[backend] = (logits, full[0].float(),
                         [idx for idx, _ in routing])
    (d_a, f_a, r_a), (d_r, f_r, r_r) = runs["arrayflex"], runs["ref"]
    tol = MODEL_TOL[torch.float32]
    out = {"decode": _rel(f"reduced {cfg.name} decode arrayflex vs ref "
                          f"(fp32, {HYBRID_STEPS} steps)", d_a, d_r, tol),
           "forward": _rel(f"reduced {cfg.name} lm.forward arrayflex vs ref "
                           f"(fp32, S={HYBRID_FWD_SEQ})", f_a, f_r, tol)}
    same = len(r_a) == len(r_r) and all(
        torch.equal(x, y) for x, y in zip(r_a, r_r))
    out["same_experts"] = same
    out["launches_per_step"] = {k: v // HYBRID_STEPS
                                for k, v in counted.items() if v}
    log(f"  same top-{cfg.moe.top_k} experts at all {len(r_a)} routings: "
        f"{same}; launches per decode step {out['launches_per_step']}")
    return out, counted


# ---------------------------------------------------------------------------
# the last families and the three dense archs at full width

MIXTRAL_ARCH = "mixtral-8x22b"
VLM_ARCH = "llama-3.2-vision-90b"
AUDIO_ARCH = "whisper-base"
DENSE_ARCHS = ("llama3-8b", "qwen2.5-14b", "stablelm-12b")
FAMILY_ARCHS = (MIXTRAL_ARCH, VLM_ARCH, AUDIO_ARCH) + DENSE_ARCHS
BACKENDS = ("arrayflex", "arrayflex_int8", "arrayflex_w8a8")
# (layers, backends) of each tree built in turn, bf16 parameters; the
# default is the published depth on all three backends.  mixtral: 5.0 GB
# a layer, 8 layers on arrayflex, 6 on the int8 backends (each engine
# holds the bf16 tree and its int8 copy); the vlm: two super-blocks of 5
# (8 self-attention layers, 2 cross layers) of 100
FAMILY_TREES = {
    MIXTRAL_ARCH: ((8, ("arrayflex",)),
                   (6, ("arrayflex_int8", "arrayflex_w8a8"))),
    VLM_ARCH: ((10, BACKENDS),),
}
# serving: mixtral's window cut to 16, below FAMILY_MAX_SEQ, so that the
# ring wraps within the prompts; token prefill for the three families,
# batched prefill for the dense archs (PROMPT_LENS, MAX_SEQ)
MIXTRAL_SERVE_WINDOW = 16
FAMILY_MAX_SEQ, FAMILY_MAX_NEW = 64, 8
# lm.prefill at B = 1, on arrayflex: (tokens, context rows).  mixtral at
# the published window 4096: S = 4608 keeps a ring of 4096 rolled by 512
# (the chunked scan above attn_dense_below); the vlm against 1600 image
# tokens; whisper's 64 decoder tokens against 1500 encoded frames
FAMILY_FWD = {MIXTRAL_ARCH: (4608, 0), VLM_ARCH: (512, 1600),
              AUDIO_ARCH: (64, 1500)}
# fp32 parity against ref at this depth (None: the published one): the
# families' lm.forward (S = PARITY_SEQ, the full context) and
# FAMILY_PARITY_STEPS decode steps, mixtral with a ring of
# MIXTRAL_PARITY_WINDOW that wraps within them; the dense archs'
# prefill_step + decode_step (:func:`parity_phase`)
PARITY_LAYERS = {MIXTRAL_ARCH: 2, VLM_ARCH: 5, AUDIO_ARCH: None,
                 **{a: 2 for a in DENSE_ARCHS}}
PARITY_SEQ, FAMILY_PARITY_STEPS, MIXTRAL_PARITY_WINDOW = 32, 6, 4


def family_batch(cfg, S: int, n_ctx: int, seed: int = 5):
    """Seeded tokens (1, S) and the family's context input: image
    embeddings (1, n_ctx, d_frontend) or audio frames, fp32."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, S),
                                     generator=gen, device="cuda")}
    if cfg.family in ("vlm", "audio"):
        batch["image_embeds" if cfg.family == "vlm" else "frames"] = \
            torch.randn((1, n_ctx, cfg.d_frontend), generator=gen,
                        device="cuda")
    return batch


def family_prefill(cfg, params):
    """``lm.prefill`` of ``cfg`` at B = 1 (:data:`FAMILY_FWD`) on the
    served tree: a recorded warm-up run (its K1 / K2 sites), then the run
    whose launch counters are set to 0 just before and read just after
    (held to :func:`forward_launches`), its host-clock time, peak memory,
    logits and cache leaves (``lm.init_cache``'s at S, the cross leaves
    as long as the context), and a profiled run's device-busy time."""
    S, n_ctx = FAMILY_FWD[cfg.name]
    served = lm.prepare_params(cfg, params)
    batch = family_batch(cfg, S, n_ctx)
    with recorded_sites(cfg.name) as sites:              # warm-up
        lm.prefill(cfg, served, batch)
    _free()
    torch.cuda.reset_peak_memory_stats()
    ag.reset_launches()                     # counts: 0 just before the run
    fa.reset_launches()
    t0 = time.perf_counter()
    logits, caches = lm.prefill(cfg, served, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(ag.LAUNCHES, **fa.LAUNCHES)   # read just after
    peak = torch.cuda.max_memory_allocated()
    check_launches(f"{cfg.name} prefill S={S}", launches,
                   forward_launches(cfg, S, n_ctx))
    want = lm.init_cache(cfg, 1, S, n_cross=n_ctx or None)
    leaves = [[(k, tuple(t.shape), t.dtype) for k, t in c.items()]
              for c in caches]
    if (tuple(logits.shape) != (1, cfg.padded_vocab)
            or not bool(torch.isfinite(logits).all())
            or leaves != [[(k, tuple(t.shape), t.dtype)
                           for k, t in c.items()] for c in want]):
        raise AssertionError(f"{cfg.name} prefill S={S}: logits "
                             f"{tuple(logits.shape)} or caches {leaves} "
                             f"wrong, or non-finite logits")
    del logits, caches, want
    log(f"  {cfg.name} x{cfg.n_layers} lm.prefill B=1 S={S}"
        f"{f' against {n_ctx} context rows' if n_ctx else ''}: "
        f"{wall_ms:.1f} ms host clock, peak {peak / 2**30:.2f} GiB; "
        f"launches { {k: v for k, v in launches.items() if v} }")
    prof = profile_device(lambda: lm.prefill(cfg, served, batch), wall_ms,
                          f"prefill of {S} tokens")
    del served
    _free()
    return dict(S=S, n_ctx=n_ctx, n_layers=cfg.n_layers, prefill_ms=wall_ms,
                max_memory_allocated_bytes=peak, launches=launches,
                profile=prof), sites


def family_kernel_phase(cell_sites, gen):
    """Each recorded site (:func:`recorded_sites`, by phase) checked
    against its plain version at the path's k in bf16 and fp32 (the
    full-sequence prefill's sites to :func:`step_tol`, as
    :func:`prefill_kernel_phase`'s; the others to :func:`kernel_tol`),
    then timed in the path's dtype.  Returns the rows and each kernel's
    largest error (bf16 for the tensor-core kernels, fp32 for the FFMA
    kernels of fp32 x)."""
    rows, max_err = [], {}
    for phase, sites in cell_sites.items():
        full = phase.startswith("prefill S=")
        for site in sites:
            errs = {}
            for dt in (torch.bfloat16, torch.float32):
                dname = str(dt).split(".")[-1]
                errs[f"{dname}/k{site.k}"] = check_site(
                    site, dt, gen, site.k, step_tol if full else None)
                name = site.kernel_key(dt)
                if dt == torch.bfloat16 or name in FFMA_FP32:
                    max_err[name] = max(max_err.get(name, 0.0),
                                        errs[f"{dname}/k{site.k}"])
            t = time_site(site, gen, max(4, 2 * site.copies))
            rows.append(dict(phase=phase, cell=site.cell, site=site.name,
                             kernel=site.kernel, form=site.form,
                             launch_name=site.kernel_key(site.time_dtype),
                             shape=site.shape, per_step=site.per_step,
                             max_abs_err=errs, **t))
            log(f"  {site.cell} {phase:17s} {site.form:5s} {site.name:22s} "
                f"{str(site.shape):28s} x{site.per_step:<3d} "
                f"{t['dtype']:8s} k={t['k']} kernel {_us(t['ms'])} us  "
                f"plain {_us(t['plain_ms'])} us  library "
                f"{_us(t['library_ms'])} us  bound "
                f"{t['bound_ms'] * 1e3:8.2f} us ({t['bound_by']})  err "
                f"{max(errs.values()):.3g}")
            _free()
    return rows, max_err


def family_totals(rows):
    """Per (phase, kernel) totals of one cell's rows (:func:`_step_totals`:
    a decode step, a prefill chunk step, or one prefill).  A prefill
    chunk's totals leave out its unembed of B rows, as
    :func:`summarize`'s chunk totals do (so that W8A8 has an ``_int_mm``
    library time: no site of 16 rows or fewer has one)."""
    out = {}
    for phase in dict.fromkeys(r["phase"] for r in rows):
        sel = [r for r in rows if r["phase"] == phase and not (
            phase.startswith("prefill chunk") and r["shape"][-3] <= 16)]
        for name in dict.fromkeys(r["launch_name"] for r in sel):
            out[f"{phase} {name}"] = _step_totals(
                [r for r in sel if r["launch_name"] == name])
    return out


def cross_parity(cfg, params):
    """fp32 on the card, ``cfg``'s depth: ``lm.forward`` of PARITY_SEQ
    tokens (B = 1, the full-size context) and FAMILY_PARITY_STEPS decode
    steps (B = 2, a zero fp32 cache: the served cross leaves) on the
    kernels against ``ref`` within MODEL_TOL, the kernels' run counted
    (all on the FFMA kernels; launches :func:`forward_launches` plus
    :func:`expected_launches` a step)."""
    S, n_ctx = PARITY_SEQ, FAMILY_FWD[cfg.name][1]
    batch = family_batch(cfg, S, n_ctx, seed=6)
    B = 2
    gen = torch.Generator(device="cuda").manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (FAMILY_PARITY_STEPS, B),
                         generator=gen, device="cuda")
    res, counted = {}, None
    for backend in ("arrayflex", "ref"):
        c = dataclasses.replace(cfg, gemm_backend=backend,
                                compute_dtype="float32")
        p = lm.prepare_params(c, params)

        def run():
            full, _, _ = lm.forward(c, p, batch)
            cache = lm.init_cache(c, B, 16, dtype=torch.float32)
            steps = []
            for t in range(FAMILY_PARITY_STEPS):
                pos = torch.tensor([t, t + 1], device="cuda")
                lg, cache = lm.decode_step(c, p, cache, toks[t], pos)
                steps.append(lg.float())
            return full[0].float(), torch.cat(steps)

        if backend == "arrayflex":
            res[backend], counted = _counted(f"fp32 {cfg.name}", c, run)
            want = expected_launches(c, FAMILY_PARITY_STEPS)
            for name, n in forward_launches(c, S, n_ctx).items():
                if name in want:
                    want[name] += n
            check_launches(f"fp32 {cfg.name} forward + decode", counted,
                           want)
        else:
            res[backend] = run()
        del p
        _free()
    tol = MODEL_TOL[torch.float32]
    (fa_, da), (fr, dr) = res["arrayflex"], res["ref"]
    what = f"{cfg.name} x{cfg.n_layers} fp32 arrayflex vs ref"
    return dict(forward=_rel(f"{what}: lm.forward S={S}", fa_, fr, tol),
                decode=_rel(f"{what}: {FAMILY_PARITY_STEPS} decode steps",
                            da, dr, tol)), counted


def family_phase(arch):
    """One new cell at full published width, bf16 parameters (seed 0),
    trees built and freed one at a time (:data:`FAMILY_TREES`): served on
    each backend (:func:`serving_phase`: every request ``ok``, launches
    per step from :func:`step_sites`, the decode step profiled, peak
    memory) with its decode and prefill-chunk sites recorded; the
    families' ``lm.prefill`` (:func:`family_prefill`); then, the tree
    freed, every recorded site checked and timed
    (:func:`family_kernel_phase`), and fp32 parity at
    :data:`PARITY_LAYERS`.  Returns the cell's results, rows, kernel
    errors, the runs whose launches count and the counted fp32 runs."""
    base = dataclasses.replace(get_config(arch), gemm_backend="arrayflex",
                               compute_dtype="bfloat16",
                               param_dtype="bfloat16")
    dense = arch in DENSE_ARCHS
    prompt_lens, max_seq = ((PROMPT_LENS, MAX_SEQ) if dense
                            else (MOE_PROMPT_LENS, FAMILY_MAX_SEQ))
    over = ({"sliding_window": MIXTRAL_SERVE_WINDOW}
            if arch == MIXTRAL_ARCH else {})
    out = dict(serving={}, n_layers={})
    sites, runs, fp32_runs = {}, [], []
    for L, backends in FAMILY_TREES.get(arch, ((base.n_layers, BACKENDS),)):
        cfg = dataclasses.replace(base, n_layers=L)
        t0 = time.perf_counter()
        params = lm.init_params(cfg, seed=0)
        torch.cuda.synchronize()
        n_bytes = sum(t.numel() * t.element_size() for t in _tensors(params))
        log(f"  {arch} x{L}: {n_bytes / 1e9:.2f} GB of bf16 parameters "
            f"built in {time.perf_counter() - t0:.1f} s")
        for backend in backends:
            bcfg = dataclasses.replace(cfg, gemm_backend=backend, **over)
            res = serving_phase(bcfg, params, prompt_lens, FAMILY_MAX_NEW,
                                max_seq, record=True)
            res["param_bytes"] = n_bytes
            for phase, s in res.pop("sites").items():
                # the float sites of a quantizing backend's step (the
                # attention products, the router) are arrayflex's
                sites.setdefault(phase, []).extend(
                    st for st in s
                    if backend == "arrayflex" or st.form != "float")
            out["serving"][backend] = res
            out["n_layers"][backend] = L
            runs.append(res)
            _free()
        if arch in FAMILY_FWD and "arrayflex" in backends:
            out["prefill"], s = family_prefill(cfg, params)
            sites[f"prefill S={out['prefill']['S']}"] = s
            runs.append(out["prefill"])
        del params
        _free()
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows, max_err = family_kernel_phase(sites, gen)
    out["kernel_totals"] = family_totals(rows)
    for key, t in out["kernel_totals"].items():
        lib = t["library_ms"]
        log(f"  {arch} {key}: kernel {t['ms']:.3f} / plain "
            f"{t['plain_ms']:.3f} / library "
            f"{'none' if lib is None else f'{lib:.3f}'} / bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
    L = PARITY_LAYERS[arch] or base.n_layers
    cfg = dataclasses.replace(base, n_layers=L)
    if arch == MIXTRAL_ARCH:
        cfg = dataclasses.replace(cfg, sliding_window=MIXTRAL_PARITY_WINDOW)
    params = lm.init_params(cfg, seed=0)
    if dense:
        out["parity"] = parity_phase(cfg, params)
    else:
        out["parity"], counted = cross_parity(cfg, params)
        fp32_runs.append(counted)
    out["parity_layers"] = L
    del params
    _free()
    return out, rows, max_err, runs, fp32_runs


def _step_totals(sel):
    """Per-step sums of the site rows ``sel``: each site's per-launch
    time and bound times its launches per step; library_ms is null where
    a site has no single call."""
    tot = {key: sum(r[key] * r["per_step"] for r in sel)
           for key in ("ms", "plain_ms", "bound_ms")}
    lib = [r["library_ms"] for r in sel]
    tot["library_ms"] = None if None in lib else sum(
        v * r["per_step"] for v, r in zip(lib, sel))
    t_bytes = sum(r["bytes"] * r["per_step"] for r in sel) / HBM_BYTES_PER_S
    t_ops = sum(r["ops"] * r["per_step"] / PEAK_OPS_PER_S[
        torch.int8 if r["form"] == "w8a8" else getattr(torch, r["dtype"])]
        for r in sel)
    tot["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    if sel and all("quantize_ms" in r for r in sel):
        tot["quantize_ms"] = sum(r["quantize_ms"] * r["per_step"]
                                 for r in sel)
    return tot


# kernel form -> the TPU kernel it replaces (arrayflex_gemm /
# arrayflex_expert_gemm / arrayflex_gemm_int8: the FFMA kernels of the fp32
# float forms and of W8 on fp32 x; arrayflex_gemm_tc /
# arrayflex_expert_gemm_tc / arrayflex_gemm_int8_tc: the tensor-core
# kernels of the bf16 float forms and of W8 on bf16 x)
REPLACES = {
    "arrayflex_gemm": "src/repro/kernels/arrayflex_gemm.py:177",
    "arrayflex_gemm_tc": "src/repro/kernels/arrayflex_gemm.py:177",
    "arrayflex_gemm_int8": "src/repro/kernels/arrayflex_gemm.py:177",
    "arrayflex_gemm_int8_tc": "src/repro/kernels/arrayflex_gemm.py:177",
    "arrayflex_gemm_w8a8": "src/repro/kernels/arrayflex_gemm.py:177",
    "arrayflex_expert_gemm": "src/repro/kernels/arrayflex_gemm.py:452",
    "arrayflex_expert_gemm_tc": "src/repro/kernels/arrayflex_gemm.py:452",
    "arrayflex_expert_gemm_int8": "src/repro/kernels/arrayflex_gemm.py:452",
    "arrayflex_expert_gemm_w8a8": "src/repro/kernels/arrayflex_gemm.py:452",
}


def summarize(results, max_err, launches):
    """One row per kernel form: its decode-site times and bounds per
    decode step of each model it serves (qwen2-0.5b's 24 layers,
    qwen3-moe-30b-a3b's 48), summed over the models; ``launches`` maps
    each form to its count over the counted runs.  Also returns the same
    totals per model (``cells``), the FFMA K1's also split into the MoE
    router and the wide sites (the weight GEMMs and the unembed), and per
    prefill-chunk step of qwen2-0.5b (``chunk``: each form's sites at the
    chunk's B x chunk rows; the unembed of B rows is left out)."""
    rows, cells = [], {}
    src = "src/repro_torch/kernels/csrc/arrayflex_gemm.cu"
    decode = [r for r in results if r["phase"] == "decode"]
    prefill = [r for r in results
               if r["phase"] == "prefill" and r["shape"][-3] > 16]
    chunk = {name: _step_totals([r for r in prefill
                                 if r["launch_name"] == name])
             for name in REPLACES
             if any(r["launch_name"] == name for r in prefill)}
    for name, replaces in REPLACES.items():
        sel = [r for r in decode if r["launch_name"] == name]
        for cell in sorted({r["cell"] for r in sel}):
            in_cell = [r for r in sel if r["cell"] == cell]
            cells.setdefault(cell, {})[name] = _step_totals(in_cell)
            if name != "arrayflex_gemm":
                continue
            for part, router in (("router", True), ("wide sites", False)):
                sub = [r for r in in_cell
                       if (r["site"] == "moe.router") == router]
                if sub:
                    cells[cell][f"{name} ({part})"] = _step_totals(sub)
        rows.append(dict(name=name, route="cuda", source=src,
                         replaces=replaces, launches=launches[name],
                         max_abs_err=max_err[name], **_step_totals(sel)))
    return rows, cells, chunk


def k3_rows(k3, launches: dict):
    """K3's rows of the kernels line, one per kernel (``flash_attention``:
    the FFMA kernel of fp32; ``flash_attention_tc``: the tensor-core kernel
    of bf16): times and bounds summed over the kernel's cases that have a
    library time (all but the case with fully masked rows, where
    scaled_dot_product_attention returns NaN and is not timed);
    ``launches`` maps each kernel to its count in the K3 path's run (one
    per case); the error is the largest over the kernel's cases."""
    rows = []
    for name in ("flash_attention", "flash_attention_tc"):
        cases = [r for r in k3 if r["kernel"] == name]
        sel = [r for r in cases if r["library_ms"] is not None]
        tot = {key: sum(r[key] for r in sel)
               for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
        t_bytes = sum(r["bytes"] for r in sel) / HBM_BYTES_PER_S
        t_ops = sum(r["ops"] / PEAK_OPS_PER_S[getattr(torch, r["dtype"])]
                    for r in sel)
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:27",
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in cases),
            bound_by="bytes" if t_bytes >= t_ops else "operations", **tot))
    return rows


def narrow_sites(cfg, moe_cfg):
    """The K1 decode sites (M = BATCH rows) that fp32 x runs on the narrow
    FFMA tile, for both models: every K1 site of the decode path in the
    float form (the dual swiglu and the unembed among them, and the MoE
    router) and every W8 site (``arrayflex_int8``'s weight GEMMs)."""
    out = []
    for c, max_seq in ((cfg, MAX_SEQ), (moe_cfg, MOE_MAX_SEQ)):
        float_sites = main_path_sites(c, BATCH, max_seq)
        if c.moe is not None:
            float_sites += moe_sites(c)
        out += [s for s in float_sites + quant_sites(c, BATCH, "int8",
                                                     max_seq)
                if s.kernel == "arrayflex_gemm"]
    return out


def narrow_bank_sites(moe_cfg):
    """The MoE expert banks of ``moe_cfg`` at decode in K2's int8-only
    form (``arrayflex_int8``): T = one capacity row per expert, so every
    one runs the narrow FFMA tile."""
    return [dataclasses.replace(s, form="int8") for s in moe_sites(moe_cfg)
            if s.kernel == "arrayflex_expert_gemm"]


def w8a8_sites(cfg, moe_cfg):
    """Every W8A8 decode site of both models (``arrayflex_w8a8``, B rows):
    the K1 weight GEMMs (the dual swiglu and the unembed among them),
    attn.qk on K2's W8A8 form, and the MoE expert banks on it (one
    capacity row of each expert); every one runs the W8A8 narrow tile."""
    out = []
    for c, max_seq in ((cfg, MAX_SEQ), (moe_cfg, MOE_MAX_SEQ)):
        out += quant_sites(c, BATCH, "w8a8", max_seq)
        if c.moe is not None:
            out += [dataclasses.replace(s, form="w8a8") for s in moe_sites(c)
                    if s.kernel == "arrayflex_expert_gemm"]
    return out


def tc_report(cfg, moe_cfg, chunk: int) -> None:
    """The tensor-core kernels' and the narrow FFMA tile's registers and
    spills (ptxas, per instantiation) and the dynamic shared memory their
    launchers take at the main path's shapes (K1 float and W8: decode M = 4
    at the planned k = 4, prefill at k = 1 and 2; K2: an MoE bank's T = 1,
    the prefill chunk's and the 2048-token prefill's attn.qk (N = S) and
    attn.pv (N = 64, the 128 x 64 tile); the narrow tile: its width and
    shared memory at every fp32-x K1 decode site of both models
    (:func:`narrow_sites`, float and W8, at the planned k), at the int8
    MoE banks (:func:`narrow_bank_sites`, fp32 and bf16 x, the grid
    counted over 128 experts), K2's fp32 bank and decode attention (T = 7,
    fp32 and bf16 w); the W8A8 narrow tile
    (``af_gemm_w8a8_narrow_kernel``): its width and shared memory at every
    W8A8 decode site of both models (:func:`w8a8_sites`, at the planned
    k's quantization step); the W8A8 int8 tensor-core tile
    (``af_gemm_w8a8_tc_kernel``, after ``af_w8a8_quant_kernel``): its
    width, shared memory and scratch at every W8A8 site of qwen2-0.5b's
    prefill chunk of BATCH x ``chunk`` rows (:func:`w8a8_tile`); K3 at
    each head dim)."""
    for stem, text in build.PTXAS_INFO.items():
        entry = None
        for line in text.splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif entry and any(key in entry for key in (
                    "tc_kernel", "combine", "narrow_kernel",
                    "quant_kernel")) and (
                    "Used" in line or "spill" in line):
                log(f"  {stem} {entry}: {line.split(':', 1)[-1].strip()}")
    glib, flib = ag._lib(), fa._lib()
    for M, k in ((4, 4), (1024, 2), (2048, 1)):
        for entry, quant in (("af_gemm_tc", 0), ("af_gemm_q_tc", 1)):
            log(f"  {entry} dynamic shared memory at M = {M}, k = {k}: "
                f"{glib.af_gemm_tc_smem(M, 896, k, 0, quant)} B (dual "
                f"{glib.af_gemm_tc_smem(M, 896, k, 1, quant)} B)")
    for what, (T, N, k) in (("MoE bank", (1, 768, 4)),
                            ("prefill-chunk attn.qk", (1792, 256, 2)),
                            ("prefill-chunk attn.pv", (1792, 64, 2)),
                            ("S = 2048 attn.qk", (14336, 2048, 1)),
                            ("S = 2048 attn.pv", (14336, 64, 1))):
        log(f"  af_expert_gemm_tc dynamic shared memory at the {what} (T = "
            f"{T}, N = {N}, k = {k}): {glib.af_gemm_tc_smem(T, N, k, 0, 0)} B")
    for site in narrow_sites(cfg, moe_cfg):
        M, K, N = site.shape
        w_dtype = 2 if site.form == "int8" else 0
        dual, k = int(bool(site.flags.get("dual"))), planned_k(site)
        log(f"  narrow FFMA tile at {site.cell} {site.form} {site.name} "
            f"{site.shape} k = {k}: {glib.af_narrow_cols(M, N, w_dtype, 0)} "
            f"columns a block, "
            f"{glib.af_narrow_smem(M, N, K, k, w_dtype, dual, 0, 0)} B")
    for site in narrow_bank_sites(moe_cfg):
        E, T, K, N = site.shape
        k = planned_k(site)
        for x_name, x_dtype in (("fp32", 0), ("bf16", 1)):
            log(f"  narrow FFMA tile at {site.cell} int8 {site.name} "
                f"{site.shape} {x_name} x k = {k}: "
                f"{glib.af_narrow_cols(T, N, 2, E)} columns a block "
                f"({E} experts), "
                f"{glib.af_narrow_smem(T, N, K, k, 2, 0, E, x_dtype)} B")
    for what, (T, N, K, k, w_dtype) in (
            ("K2 fp32 bank", (1, 768, 2048, 4, 0)),
            ("K2 decode attn.qk, bf16 cache", (7, MAX_SEQ, 64, 1, 1)),
            ("K2 decode attn.pv", (7, 64, MAX_SEQ, 2, 0))):
        log(f"  narrow FFMA tile at the {what} (T = {T}, N = {N}, K = {K}, "
            f"k = {k}): {glib.af_narrow_cols(T, N, w_dtype, 1)} columns a "
            f"block, {glib.af_narrow_smem(T, N, K, k, w_dtype, 0, 1, 0)} B")
    for site in w8a8_sites(cfg, moe_cfg):
        rows, N, batch = site_rows(site)
        K, k = site.shape[-2], planned_k(site)
        qkk = ag.quant_tiles(rows, K, k)[1]
        dual = int(bool(site.flags.get("dual")))
        log(f"  W8A8 narrow tile at {site.cell} {site.name} {site.shape} "
            f"k = {k} (quant_kk {qkk}): {glib.af_w8a8_cols(rows, N, batch)} "
            f"columns a block, "
            f"{glib.af_w8a8_smem(rows, N, K, qkk, dual, batch)} B")
    for site in quant_sites(cfg, BATCH * chunk, "w8a8"):
        if site_rows(site)[0] <= 16:
            continue
        k = planned_k(site)
        t = w8a8_tile(site, k)
        log(f"  W8A8 int8 tensor-core tile at {site.cell} {site.name} "
            f"{site.shape} k = {k} (quantization tile {t['quant_tile']}): "
            f"{t['tile_cols']} columns a block, {t['tile_smem']} B shared "
            f"memory, {t['scratch_bytes']} B scratch")
    log("  flash_attention_tc dynamic shared memory at D = 32 / 64 / 128: "
        + " / ".join(str(flib.flash_attention_tc_smem(D))
                     for D in (32, 64, 128)) + " B")


# ---------------------------------------------------------------------------
# phase 7, training: lm.loss_fn + AdamW on the xla backend (no kernel)

# (a)-(b): full-width models at the trainer's defaults (B = 8, S = 256),
# SyntheticLM seed 0, OptConfig(warmup_steps=2): (arch, layers or None
# for full depth, steps, peak learning rate).  The MoE's d_model 2048
# takes a smaller rate: Adam's first steps move every weight by about lr,
# and at the default 3e-4 its loss rose over 3 steps (12.47, 12.49, 15.02)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_WARMUP = 8, 256, 2
TRAIN_CELLS = (("qwen2-0.5b", None, 10, 3e-4),
               ("mamba2-370m", None, 4, 3e-4),
               ("qwen3-moe-30b-a3b", 2, 3, 5e-5))
# the n = 2 microbatched step against the single step on one state and
# batch: a full-width card run measured the two losses equal to 5 places
# (was 0.05, the reference's tests/test_models_smoke.py bound).  The
# gradient each step applied, (m_new - b1 m) / (1 - b1) from its first
# moments, is held leaf by leaf within MICRO_GRAD_RTOL of the leaf's max
# (bf16 compute: each half's weight gradient leaves its GEMM rounded to
# bf16, 2^-9 of itself, and the whole batch's once, so about 1.5 x 2^-8
# of a leaf's max can part two right steps; a microbatch dropped, counted
# twice or not divided by n moves a leaf by half its max or more).  The
# new parameters are held within MICRO_PARAM_LR x the step's learning
# rate: the card measured 0.25 x lr here and 0.055 x lr in (f), whose
# steps start from a fresh state, where an update lost or of the other
# sign moves an element by lr or 2 x lr
MICRO_N, MICRO_LOSS_TOL, MICRO_GRAD_RTOL, MICRO_PARAM_LR = 2, 1e-3, 2**-6, 0.5
# (c)-(d): 2 layers of full-width qwen2-0.5b in fp32, B = 2, S = 64; the
# CPU tolerances of tests/test_torch_train.py
PARITY_TRAIN_LAYERS, PARITY_TRAIN_B, PARITY_TRAIN_S = 2, 2, 64
TRAIN_LOSS_ATOL, TRAIN_GRAD_RTOL = 1e-5, 1e-4
# (d): steps, checkpoint cadence and the step that fails once
RESTART_STEPS, RESTART_CKPT_EVERY, RESTART_FAIL_AT = 8, 3, 5
# (e): sharded training of full-width qwen2-0.5b through launch.train.main
# at the trainer's defaults (B = 8, S = 256, bf16 compute, remat "full"),
# over meshes of four logical devices on the one card, against the
# unsharded run.  The loss tolerance: a column-parallel or data-split
# shard runs each output element's whole K-sum at another GEMM shape
# (cuBLAS may block it otherwise: a bf16 output one rounding step apart),
# a row-parallel shard adds fp32 partials and rounds once as the
# unsharded product does; such one-step flips on a fraction of the bf16
# activations move the mean cross-entropy of 2048 tokens by ~1e-4 (the
# n = 2 microbatched step, whose GEMMs change shape alike, moved it by
# < 1e-5 on the card), and 4 warmup steps at lr <= 1.2e-5 carry it on
# little: 5e-3 holds every step's loss with margin
SHARDED_TRAIN_MESHES = ((2, 2), (1, 2))
SHARDED_TRAIN_STEPS, SHARDED_TRAIN_LOSS_TOL = 4, 5e-3
# (f): the fp32 parity cell (c) sharded at (2, 2), n = 1 and 2
SHARDED_PARITY_MESH = (2, 2)
# (g): remat "full" against "none" at the defaults, steps timed each
REMAT_STEPS = 3


def train_cfg(arch: str, layers=None, **kw):
    """The training config: the arch's published widths, its default fp32
    parameters and bf16 compute, the ``xla`` backend (the reference's
    training backend; the collapse backends have no backward pass)."""
    cfg = dataclasses.replace(get_config(arch), gemm_backend="xla", **kw)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def restart_schedule(n_steps: int, ckpt_every: int, fail_at: int):
    """(steps run in order, checkpoint steps written) of
    ``FaultToleranceManager.run`` with one failure injected before step
    ``fail_at``: the run restores the last checkpoint at or below
    ``fail_at`` and replays from there."""
    ran, saved, step, failed = [], [], 0, False
    while step < n_steps:
        if step == fail_at and not failed:
            failed = True
            step = max((s for s in saved if s <= fail_at), default=0)
            continue
        ran.append(step)
        step += 1
        if step % ckpt_every == 0:
            saved.append(step)
    return ran, saved


def _train_batch(data, step: int, dev="cuda"):
    return {k: torch.as_tensor(v).to(dev, torch.int64)
            for k, v in data.batch_at(step).items()}


def _fingerprint(params):
    """A strided sample of every leaf (a change anywhere in a leaf almost
    surely shows in it: AdamW moves every element it updates)."""
    return [t.detach().flatten()[::997].float().clone()
            for t in tree_lib.leaves(params)]


def _worst_rel(got, want):
    """(worst leaf error / its max |want|, that leaf's path)."""
    worst = (0.0, "")
    for (path, g), w in zip(tree_lib.leaves_with_path(got),
                            tree_lib.leaves(want)):
        scale = float(w.float().abs().max())
        err = float((g.float() - w.float()).abs().max())
        rel = err / scale if scale else err
        worst = max(worst, (rel, tree_lib.path_key(path)))
    return worst


def _abs_diffs(got, want):
    """(max |got - want|, path) of every leaf."""
    return [(float((g.float() - w.float()).abs().max()),
             tree_lib.path_key(path))
            for (path, g), w in zip(tree_lib.leaves_with_path(got),
                                    tree_lib.leaves(want))]


def train_run(arch: str, layers, steps: int, lr: float, card: str,
              profile=False, micro=False):
    """``steps`` AdamW steps of ``arch`` on the card: every loss and
    gradient norm finite, every parameter leaf changed, the last loss
    below the first; the host-clock time of each step, tokens/s and peak
    memory; with ``profile`` one more step under torch.profiler; with
    ``micro`` the n = 2 microbatched step against the single step on one
    state and batch."""
    cfg = train_cfg(arch, layers)
    oc = OptConfig(lr=lr, warmup_steps=TRAIN_WARMUP)
    _free()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, seed=0)
    opt = adamw_init(params, oc)
    step_fn = api.make_train_step(cfg, oc)
    data = SyntheticLM(DataConfig(seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH,
                                  vocab_size=cfg.vocab_size, seed=0))
    before = _fingerprint(params)
    losses, gnorms, aux, step_ms = [], [], [], []
    for s in range(steps):
        batch = _train_batch(data, s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, met = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
        aux.append(float(met["aux"]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    changed = [not torch.equal(a, b)
               for a, b in zip(before, _fingerprint(params))]
    steady = step_ms[1:] or step_ms
    ms = float(np.median(steady))
    out = dict(arch=arch, layers=cfg.n_layers, lr=lr, batch=TRAIN_BATCH,
               seq=TRAIN_SEQ, steps=steps, losses=losses, grad_norms=gnorms,
               aux=aux, step_ms=step_ms, median_step_ms=ms,
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / ms * 1e3,
               peak_gib=peak, leaves_changed=sum(changed),
               leaves=len(changed))
    log(f"  {arch} x{cfg.n_layers} (B {TRAIN_BATCH}, S {TRAIN_SEQ}, "
        f"{cfg.param_dtype} params, {cfg.compute_dtype} compute, lr {lr}): "
        f"loss "
        f"{' '.join(f'{l:.4f}' for l in losses)}")
    log(f"    grad norm {' '.join(f'{g:.3f}' for g in gnorms)}; aux "
        f"{aux[-1]:.6f}; step {ms:.2f} ms (median of steps 1-{steps - 1}, "
        f"host clock; first {step_ms[0]:.1f}), {out['tokens_per_s']:.0f} "
        f"tokens/s, peak {peak:.2f} GiB ({card})")
    if not (np.isfinite(losses).all() and np.isfinite(gnorms).all()):
        raise AssertionError(f"{arch} training: non-finite loss or gradient "
                             f"norm: {losses} {gnorms}")
    if not all(changed):
        raise AssertionError(f"{arch} training: {len(changed) - sum(changed)}"
                             f" parameter leaves did not change")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{arch} training: loss did not fall: "
                             f"{losses}")
    if cfg.moe is not None:
        banks = [float(opt["m"]["blocks"][0]["moe"][k].float().abs().sum())
                 for k in ("wi_gate", "wi_up", "wo")]
        out["expert_moment_abs_sum"] = banks
        log(f"    expert banks' first moments (|m| sums: gradients reached "
            f"the experts): {banks}")
        if not (all(b > 0 for b in banks) and all(a > 0 for a in aux)):
            raise AssertionError(f"{arch}: no expert gradient or aux loss: "
                                 f"{banks} {aux}")
    batch = _train_batch(data, steps)
    if profile:
        out["profile"] = profile_device(
            lambda: step_fn(params, opt, batch), ms,
            f"{arch} train step")
    if micro:
        p1, o1, m1 = step_fn(params, opt, batch)
        p2, o2, m2 = api.make_train_step(cfg, oc, MICRO_N)(params, opt, batch)
        one, two, lr_step = float(m1["loss"]), float(m2["loss"]), \
            float(m1["lr"])
        applied = lambda o: tree_lib.tree_map(
            lambda new, m: (new - oc.b1 * m.float()) / (1 - oc.b1), o["m"],
            opt["m"])
        grad_rel, grad_key = _worst_rel(applied(o2), applied(o1))
        worst, worst_key = max(_abs_diffs(p2, p1))
        tol = MICRO_PARAM_LR * lr_step
        out["micro"] = dict(loss_1=one, loss_n=two, n=MICRO_N,
                            tol=MICRO_LOSS_TOL, lr=lr_step,
                            grad_rel_err=grad_rel, grad_worst=grad_key,
                            grad_rtol=MICRO_GRAD_RTOL,
                            param_max_abs_diff=worst, param_worst=worst_key,
                            param_tol=tol)
        log(f"    n_microbatches={MICRO_N}: loss {two:.6f} against the "
            f"single step's {one:.6f} (|diff| {abs(one - two):.3g}, tol "
            f"{MICRO_LOSS_TOL}); applied gradient within {grad_rel:.3g} of "
            f"its leaf's max ({grad_key}; tol {MICRO_GRAD_RTOL:.3g}); new "
            f"parameters within {worst:.3g} ({worst_key}; tol "
            f"{MICRO_PARAM_LR} x lr = {tol:.3g})")
        if not abs(one - two) < MICRO_LOSS_TOL:
            raise AssertionError(f"microbatched loss {two} vs {one}")
        if not grad_rel <= MICRO_GRAD_RTOL:
            raise AssertionError(f"microbatched gradient: {grad_key} off by "
                                 f"{grad_rel} of its max")
        if not worst <= tol:
            raise AssertionError(f"microbatched parameters: {worst_key} "
                                 f"moved {worst} > {tol}")
        del p1, p2, o1, o2
    del params, opt
    _free()
    return out


def train_parity(card: str):
    """(c): the loss and every gradient leaf of 2 layers of full-width
    qwen2-0.5b in fp32 on the card against the port's CPU run on the same
    tree and tokens (TF32 off)."""
    cfg = train_cfg("qwen2-0.5b", PARITY_TRAIN_LAYERS,
                    compute_dtype="float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    params = lm.init_params(cfg, seed=0, device="cpu")
    data = SyntheticLM(DataConfig(seq_len=PARITY_TRAIN_S,
                                  global_batch=PARITY_TRAIN_B,
                                  vocab_size=cfg.vocab_size, seed=0))
    (cpu_loss, _), cpu_grads = api.value_and_grad(
        cfg, params, _train_batch(data, 0, "cpu"))
    (loss, _), grads = api.value_and_grad(
        cfg, tree_lib.tree_map(lambda t: t.cuda(), params),
        _train_batch(data, 0))
    loss_err = abs(float(loss) - float(cpu_loss))
    worst = 0.0
    for (path, g), w in zip(tree_lib.leaves_with_path(grads),
                            tree_lib.leaves(cpu_grads)):
        scale = float(w.abs().max())
        err = float((g.cpu() - w).abs().max())
        worst = max(worst, err / scale if scale else err)
        if not err <= TRAIN_GRAD_RTOL * scale:
            raise AssertionError(f"fp32 gradient {tree_lib.path_key(path)}:"
                                 f" {err} > {TRAIN_GRAD_RTOL} x {scale}")
    log(f"  (c) fp32 parity, {PARITY_TRAIN_LAYERS} layers, B "
        f"{PARITY_TRAIN_B}, S {PARITY_TRAIN_S}: loss {float(loss):.6f} "
        f"(CPU {float(cpu_loss):.6f}, |diff| {loss_err:.3g}, tol "
        f"{TRAIN_LOSS_ATOL}); worst gradient leaf error / its max |g| "
        f"{worst:.3g} (tol {TRAIN_GRAD_RTOL}) ({card})")
    if not loss_err <= TRAIN_LOSS_ATOL:
        raise AssertionError(f"fp32 loss {float(loss)} vs CPU "
                             f"{float(cpu_loss)}")
    return dict(loss=float(loss), cpu_loss=float(cpu_loss),
                loss_err=loss_err, worst_grad_rel_err=worst)


def train_restart(card: str):
    """(d): the same 2-layer model, 8 steps under FaultToleranceManager
    with checkpoints every 3 steps and one failure before step 5, against
    an uninterrupted run: final parameters and optimizer state equal bit
    for bit, deterministic algorithms on."""
    cfg = train_cfg("qwen2-0.5b", PARITY_TRAIN_LAYERS,
                    compute_dtype="float32")
    oc = OptConfig(warmup_steps=TRAIN_WARMUP)
    step = api.make_train_step(cfg, oc)
    data = SyntheticLM(DataConfig(seq_len=PARITY_TRAIN_S,
                                  global_batch=PARITY_TRAIN_B,
                                  vocab_size=cfg.vocab_size, seed=0))

    def run(directory, fail):
        ran = []

        def step_fn(state, batch):
            b = {k: torch.as_tensor(v).to("cuda", torch.int64)
                 for k, v in batch.items()}
            ran.append(int(state["opt"]["step"]))
            p, o, _ = step(state["params"], state["opt"], b)
            return {"params": p, "opt": o}

        fired = []

        def inject(s):
            if fail and s == RESTART_FAIL_AT and not fired:
                fired.append(s)
                raise RuntimeError("injected failure")

        params = lm.init_params(cfg, seed=0)
        ft = FaultToleranceManager(
            CheckpointManager(directory, keep=3), HeartbeatMonitor(1),
            ckpt_every=RESTART_CKPT_EVERY, max_restarts=1)
        t0 = time.perf_counter()
        state, steps, restarts = ft.run(
            {"params": params, "opt": adamw_init(params, oc)}, step_fn,
            data, RESTART_STEPS, inject_failure=inject)
        torch.cuda.synchronize()
        return state, steps, restarts, ran, time.perf_counter() - t0

    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as d:
            clean = run(os.path.join(d, "clean"), False)
            faulted = run(os.path.join(d, "faulted"), True)
    finally:
        torch.use_deterministic_algorithms(False)
    want_ran, _ = restart_schedule(RESTART_STEPS, RESTART_CKPT_EVERY,
                                   RESTART_FAIL_AT)
    a, b = tree_lib.leaves(faulted[0]), tree_lib.leaves(clean[0])
    equal = len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
    log(f"  (d) restart: {faulted[2]} restart, steps run {faulted[3]} "
        f"(want {want_ran}), final state equal to the uninterrupted run's "
        f"bit for bit: {equal} ({len(a)} leaves; {faulted[4]:.1f} s against"
        f" {clean[4]:.1f} s; deterministic algorithms, "
        f"CUBLAS_WORKSPACE_CONFIG={os.environ.get('CUBLAS_WORKSPACE_CONFIG')}"
        f") ({card})")
    if not (clean[1:3] == (RESTART_STEPS, 0) and faulted[1:3] ==
            (RESTART_STEPS, 1) and faulted[3] == want_ran and equal):
        raise AssertionError(f"restart: clean {clean[1:4]}, faulted "
                             f"{faulted[1:4]}, want {want_ran}, equal "
                             f"{equal}")
    return dict(steps_run=faulted[3], want=want_ran, bit_equal=equal,
                seconds=faulted[4], clean_seconds=clean[4])


def _timed_train_steps(times: list):
    """``api.make_train_step`` wrapped so that each step's host-clock ms
    (synchronized on both ends) goes to ``times``: the trainer CLI's own
    steps, timed from outside."""
    make = api.make_train_step

    def make_timed(*args, **kwargs):
        step = make(*args, **kwargs)

        def timed(*state):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*state)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            return out

        return timed

    return make_timed


def sharded_train_run(mesh_shape, card: str):
    """One ``launch.train.main`` run of full-width qwen2-0.5b at the
    trainer's defaults for SHARDED_TRAIN_STEPS steps under
    ``host_devices(4)`` (four views of the card), sharded at
    ``mesh_shape`` (None: unsharded): each step's loss, the median step
    ms, peak memory, the weight-block memo's bytes and the constrained
    activations a step."""
    from repro_torch.launch import train as train_cli
    argv = ["--steps", str(SHARDED_TRAIN_STEPS), "--log-every",
            str(SHARDED_TRAIN_STEPS)]
    if mesh_shape:
        argv += ["--mesh-data", str(mesh_shape[0]), "--mesh-model",
                 str(mesh_shape[1])]
    times = []
    _free()
    substrate.clear_shard_cache()
    torch.cuda.reset_peak_memory_stats()
    seen = []
    real, real_constrain = api.make_train_step, sharding.constrain

    def counted(x, name):
        if sharding.constraint_spec(name, x.ndim) is not None:
            seen.append(name)
        return real_constrain(x, name)

    api.make_train_step = _timed_train_steps(times)
    sharding.constrain = counted
    try:
        with mesh_lib.host_devices(4):
            losses = train_cli.main(argv)
    finally:
        api.make_train_step, sharding.constrain = real, real_constrain
    peak = torch.cuda.max_memory_allocated() / 2**30
    memo = substrate.shard_cache_info()
    site = substrate.SITE_PLANS["attn.wq"].shard
    out = dict(mesh=mesh_shape, losses=losses, step_ms=times,
               median_step_ms=float(np.median(times[1:] or times)),
               peak_gib=peak, memo_bytes=memo["bytes"],
               memo_blocks=memo["blocks"],
               constrained_per_step=len(seen) / len(times),
               attn_wq_shards=(site.rows, site.cols))
    log(f"  (e) mesh {mesh_shape or 'none'}: loss "
        f"{' '.join(f'{l:.5f}' for l in losses)}; step "
        f"{out['median_step_ms']:.2f} ms (median of steps 1-"
        f"{len(times) - 1}, host clock; first {times[0]:.1f}), peak "
        f"{peak:.2f} GiB, memo {memo['bytes']} B in {memo['blocks']} "
        f"blocks, {out['constrained_per_step']:.0f} constrained "
        f"activations a step, attn.wq shards (rows, cols) "
        f"{out['attn_wq_shards']} ({card})")
    if not np.isfinite(losses).all():
        raise AssertionError(f"sharded training {mesh_shape}: {losses}")
    return out


def sharded_train_phase(card: str):
    """(e): full-width qwen2-0.5b trained through ``launch.train.main``
    unsharded and over each of SHARDED_TRAIN_MESHES, every step's loss
    within SHARDED_TRAIN_LOSS_TOL of the unsharded run's."""
    base = sharded_train_run(None, card)
    out = {"unsharded": base}
    for shape in SHARDED_TRAIN_MESHES:
        run = sharded_train_run(shape, card)
        diff = float(np.max(np.abs(np.subtract(run["losses"],
                                               base["losses"]))))
        run["max_loss_diff"] = diff
        out["x".join(map(str, shape))] = run
        log(f"    mesh {shape}: losses within {diff:.3g} of the unsharded "
            f"run's (tol {SHARDED_TRAIN_LOSS_TOL}); step "
            f"{run['median_step_ms'] / base['median_step_ms']:.2f}x")
        if not (diff <= SHARDED_TRAIN_LOSS_TOL and run["memo_bytes"] == 0
                and run["attn_wq_shards"][1] == shape[1]
                and run["constrained_per_step"] > 0):
            raise AssertionError(f"sharded training {shape}: {run}")
    return out


def sharded_parity(card: str):
    """(f): the fp32 parity cell (2 layers of full-width qwen2-0.5b, B = 2,
    S = 64, TF32 off) sharded at SHARDED_PARITY_MESH against the
    unsharded run on the card: the loss and every gradient leaf, then one
    AdamW step at n = 1 and n = 2: its loss, every new first moment
    (TRAIN_GRAD_RTOL of the leaf's max) and every new parameter (within
    MICRO_PARAM_LR x lr); and the same three of the unsharded n = 2 step
    against the n = 1 step."""
    cfg = train_cfg("qwen2-0.5b", PARITY_TRAIN_LAYERS,
                    compute_dtype="float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    sh = dataclasses.replace(cfg, mesh_shape=SHARDED_PARITY_MESH)
    oc = OptConfig(warmup_steps=TRAIN_WARMUP)
    params = lm.init_params(cfg, seed=0)
    data = SyntheticLM(DataConfig(seq_len=PARITY_TRAIN_S,
                                  global_batch=PARITY_TRAIN_B,
                                  vocab_size=cfg.vocab_size, seed=0))
    batch = _train_batch(data, 0)
    (want_loss, _), want = api.value_and_grad(cfg, params, batch)
    with mesh_lib.host_devices(4):
        (loss, _), grads = api.value_and_grad(sh, params, batch)
    loss_err = abs(float(loss) - float(want_loss))
    grad_rel, grad_key = _worst_rel(grads, want)
    out = dict(mesh=SHARDED_PARITY_MESH, loss=float(loss),
               unsharded_loss=float(want_loss), loss_err=loss_err,
               worst_grad_rel_err=grad_rel, worst_grad_leaf=grad_key)
    ok = loss_err <= TRAIN_LOSS_ATOL and grad_rel <= TRAIN_GRAD_RTOL
    del grads, want
    single = None
    for n in (1, 2):
        p0, o0, m0 = api.make_train_step(cfg, oc, n)(
            params, adamw_init(params, oc), batch)
        with mesh_lib.host_devices(4):
            p1, o1, m1 = api.make_train_step(sh, oc, n)(
                params, adamw_init(params, oc), batch)
        lr_step = float(m0["lr"])
        m_rel, m_key = _worst_rel(o1["m"], o0["m"])
        step = dict(loss_err=abs(float(m1["loss"]) - float(m0["loss"])),
                    worst_m_rel_err=m_rel, worst_m_leaf=m_key,
                    param_max_abs_diff=max(_abs_diffs(p1, p0))[0],
                    lr=lr_step)
        if single is None:
            single = (p0, o0, float(m0["loss"]))
        else:
            # the unsharded n = 2 step against the n = 1 step: from a
            # fresh state the first moment is (1 - b1) x the clipped
            # gradient, so a microbatch lost shows at half a leaf's max
            step.update(
                micro_loss_err=abs(float(m0["loss"]) - single[2]),
                micro_m_rel_err=_worst_rel(o0["m"], single[1]["m"])[0],
                micro_param_max_abs_diff=max(_abs_diffs(p0, single[0]))[0])
            ok = ok and (step["micro_loss_err"] <= TRAIN_LOSS_ATOL
                         and step["micro_m_rel_err"] <= TRAIN_GRAD_RTOL
                         and step["micro_param_max_abs_diff"]
                         <= MICRO_PARAM_LR * lr_step)
        out[f"n{n}"] = step
        ok = ok and (step["loss_err"] <= TRAIN_LOSS_ATOL
                     and m_rel <= TRAIN_GRAD_RTOL
                     and step["param_max_abs_diff"]
                     <= MICRO_PARAM_LR * lr_step)
        del p0, o0, p1, o1
    del single
    n2 = out["n2"]
    log(f"  (f) fp32 parity sharded at {SHARDED_PARITY_MESH}, "
        f"{PARITY_TRAIN_LAYERS} layers, B {PARITY_TRAIN_B}, S "
        f"{PARITY_TRAIN_S}: loss |diff| {loss_err:.3g} (tol "
        f"{TRAIN_LOSS_ATOL}); worst gradient leaf {grad_rel:.3g} of its max "
        f"({grad_key}; tol {TRAIN_GRAD_RTOL}); steps n = 1 / 2: loss "
        f"|diff| {out['n1']['loss_err']:.3g} / {n2['loss_err']:.3g},"
        f" first moments {out['n1']['worst_m_rel_err']:.3g} / "
        f"{n2['worst_m_rel_err']:.3g} of their max, parameters "
        f"within {out['n1']['param_max_abs_diff']:.3g} / "
        f"{n2['param_max_abs_diff']:.3g} (tol {MICRO_PARAM_LR} x lr "
        f"= {MICRO_PARAM_LR * out['n1']['lr']:.3g}); unsharded n = 2 "
        f"against n = 1: loss |diff| {n2['micro_loss_err']:.3g}, first "
        f"moments {n2['micro_m_rel_err']:.3g} of their max, parameters "
        f"within {n2['micro_param_max_abs_diff']:.3g} ({card})")
    if not ok:
        raise AssertionError(f"sharded fp32 parity: {out}")
    del params
    _free()
    return out


def remat_phase(card: str):
    """(g): full-width qwen2-0.5b at the trainer's defaults, remat "full"
    against "none": the loss and every gradient leaf bit for bit under
    deterministic algorithms (a leaf that is not is named and held to
    TRAIN_GRAD_RTOL), then REMAT_STEPS AdamW steps of each, timed (host
    clock), with their peak memory."""
    base = train_cfg("qwen2-0.5b")
    oc = OptConfig(warmup_steps=TRAIN_WARMUP)
    data = SyntheticLM(DataConfig(seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH,
                                  vocab_size=base.vocab_size, seed=0))
    batch = _train_batch(data, 0)
    params = lm.init_params(base, seed=0)
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for remat in ("none", "full"):
            _free()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            runs[remat] = api.value_and_grad(
                dataclasses.replace(base, remat=remat), params, batch)
            torch.cuda.synchronize()
            runs[remat + "_peak"] = (torch.cuda.max_memory_allocated()
                                     - before) / 2**30
    finally:
        torch.use_deterministic_algorithms(False)
    (l0, _), g0 = runs["none"]
    (l1, _), g1 = runs["full"]
    moved = [(tree_lib.path_key(path), float((a - b).abs().max())
              / max(float(b.abs().max()), 1e-30))
             for (path, a), b in zip(tree_lib.leaves_with_path(g1),
                                     tree_lib.leaves(g0))
             if not torch.equal(a, b)]
    loss_equal = torch.equal(l0, l1)
    out = dict(loss_none=float(l0), loss_full=float(l1),
               loss_bit_equal=loss_equal, moved_leaves=moved,
               grad_peak_gib={"none": runs["none_peak"],
                              "full": runs["full_peak"]})
    del runs, g0, g1
    for remat in ("none", "full"):
        cfg = dataclasses.replace(base, remat=remat)
        step = api.make_train_step(cfg, oc)
        p, o = params, adamw_init(params, oc)
        _free()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for s in range(REMAT_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, o, _ = step(p, o, _train_batch(data, s))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[remat] = dict(step_ms=times,
                          median_step_ms=float(np.median(times[1:])),
                          peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del p, o
    log(f"  (g) remat on full-width qwen2-0.5b (B {TRAIN_BATCH}, S "
        f"{TRAIN_SEQ}): loss bit-equal {loss_equal} ({float(l1):.6f}); "
        f"gradient leaves not bit-equal: {len(moved)} "
        f"{moved[:4]}; a forward + backward's peak above what was resident "
        f"{out['grad_peak_gib']['none']:.2f} GiB (none) / "
        f"{out['grad_peak_gib']['full']:.2f} GiB (full); a train step "
        f"{out['none']['median_step_ms']:.2f} / "
        f"{out['full']['median_step_ms']:.2f} ms (host clock, median of "
        f"steps 1-{REMAT_STEPS - 1}), peak {out['none']['peak_gib']:.2f} / "
        f"{out['full']['peak_gib']:.2f} GiB (deterministic algorithms "
        f"for the gradients only) ({card})")
    bad = [kv for kv in moved if kv[1] > TRAIN_GRAD_RTOL]
    if bad or abs(float(l0) - float(l1)) > TRAIN_LOSS_ATOL:
        raise AssertionError(f"remat moved the loss or gradients: "
                             f"{float(l0)} {float(l1)} {bad}")
    del params
    _free()
    return out


def compression_phase(card: str):
    """(h): ``compress`` and ``compressed_allreduce`` over four shards of
    one full-width qwen2-0.5b layer's weight shapes (shard 2's gradients
    10x the others': the shards' own scales differ), on the card against
    the CPU, bit for bit; the all-reduce's time on the card."""
    from repro_torch.parallel import compression
    gen = torch.Generator().manual_seed(0)
    shapes = {"attn.wq": (896, 896), "mlp.wi_gate": (896, 4864),
              "mlp.wo": (4864, 896), "ln": (896,)}
    grads = [{k: torch.randn(s, generator=gen) * (10.0 if i == 2 else 1.0)
              for k, s in shapes.items()} for i in range(4)]
    errs = [{k: (torch.randn(s, generator=gen) * 1e-2).to(torch.bfloat16)
             for k, s in shapes.items()} for i in range(4)]
    cuda = lambda trees: [tree_lib.tree_map(lambda t: t.cuda(), t)
                          for t in trees]
    want = (compression.compress(grads[0], errs[0]),
            compression.compressed_allreduce(grads, errs))
    gg, ge = cuda(grads), cuda(errs)
    got = (compression.compress(gg[0], ge[0]),
           compression.compressed_allreduce(gg, ge))
    torch.cuda.synchronize()
    pairs = list(zip(tree_lib.leaves(got), tree_lib.leaves(want)))
    equal = all(a.dtype == b.dtype and torch.equal(a.cpu(), b)
                for a, b in pairs)
    t0 = time.perf_counter()
    for _ in range(5):
        compression.compressed_allreduce(gg, ge)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 5 * 1e3
    n = sum(t.numel() for t in grads[0].values())
    log(f"  (h) compress / compressed_allreduce, 4 shards of {n} elements: "
        f"{len(pairs)} leaves on the card bit-equal to the CPU's: {equal}; "
        f"the all-reduce {ms:.2f} ms (host clock) ({card})")
    if not equal:
        raise AssertionError("compression on the card differs from the CPU")
    return dict(leaves=len(pairs), bit_equal=equal, elements=n,
                allreduce_ms=ms)


def train_phase(card: str):
    """Phase 7's training runs: (a) full-width qwen2-0.5b, profiled, and
    its microbatched step; (b) mamba2-370m and qwen3-moe-30b-a3b at 2
    layers; (c) fp32 parity against the CPU; (d) the bit-exact restart;
    then :func:`mesh_train_phase`."""
    t0 = time.perf_counter()
    out = {}
    for i, (arch, layers, steps, lr) in enumerate(TRAIN_CELLS):
        out[arch] = train_run(arch, layers, steps, lr, card, profile=i == 0,
                              micro=i == 0)
    out["parity"] = train_parity(card)
    out["restart"] = train_restart(card)
    out.update(mesh_train_phase(card))
    out["seconds"] = time.perf_counter() - t0
    log(f"  training phase: {out['seconds']:.1f} s")
    return out


def mesh_train_phase(card: str):
    """Phase 7's sharded-training parts: (e) full-width qwen2-0.5b through
    ``launch.train.main`` over meshes of logical devices, (f) the fp32
    parity cell sharded, (g) remat "full" against "none", (h) the int8
    gradient compression on the card against the CPU."""
    t0 = time.perf_counter()
    out = dict(sharded=sharded_train_phase(card),
               sharded_parity=sharded_parity(card),
               remat=remat_phase(card),
               compression=compression_phase(card))
    out["mesh_seconds"] = time.perf_counter() - t0
    log(f"  sharded training, remat and compression (e)-(h): "
        f"{out['mesh_seconds']:.1f} s")
    return out


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false — "
                         "this script runs on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"[1/8] device: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {kind} x {count}")

    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"[2/8] build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for stem, text in build.PTXAS_INFO.items():
        for line in text.splitlines():
            if "Compiling entry" in line or "Used" in line \
                    or "spill" in line:
                log(f"  {stem}: {line.strip()}")
    cfg = dataclasses.replace(get_config("qwen2-0.5b"),
                              gemm_backend="arrayflex",
                              compute_dtype="bfloat16")
    moe_cfg = dataclasses.replace(get_config(MOE_ARCH),
                                  gemm_backend="arrayflex",
                                  compute_dtype="bfloat16",
                                  param_dtype="bfloat16")
    ssm_cfg = dataclasses.replace(get_config(SSM_ARCH),
                                  gemm_backend="arrayflex",
                                  compute_dtype="bfloat16",
                                  param_dtype="bfloat16")
    chunk = min(MAX_SEQ, planner.attention_plan(
        MAX_SEQ, MAX_SEQ, choices=PREFILL_CHUNK_CHOICES))
    tc_report(cfg, moe_cfg, chunk)
    log(f"[3/8] GEMM kernel checks and times (bf16, the MoE router fp32; "
        f"per call: device time from a CUDA-graph replay, eager time with "
        f"host launches; card: {card})")
    results, max_err = kernel_phase(cfg, moe_cfg, chunk, ssm_cfg=ssm_cfg)
    for form in ("int8", "w8a8"):
        r, e = kernel_phase(cfg, moe_cfg, chunk, form, ssm_cfg=ssm_cfg)
        results += r
        max_err.update(e)
    kt_quant = kt_quantize_time(cfg)
    _free()

    log(f"[4/8] flash attention (K3) through ops.attention, against its "
        f"plain version and scaled_dot_product_attention (card: {card})")
    k3, k3_launches = k3_phase()

    log(f"[5/8] serving full-width {cfg.name} on arrayflex/bf16")
    params = lm.init_params(cfg, seed=0)
    serving = {"arrayflex": serving_phase(cfg, params)}
    for backend in ("arrayflex_int8", "arrayflex_w8a8"):
        log(f"  serving full-width {cfg.name} on {backend}/bf16")
        serving[backend] = serving_phase(
            dataclasses.replace(cfg, gemm_backend=backend), params)
    log(f"  paged serving of full-width {cfg.name} (bf16): page "
        f"{planner.page_plan(MAX_SEQ)}, against the dense runs above")
    paged = paged_phase(cfg, params, serving)
    log(f"  resilient serving of full-width {cfg.name} (bf16): (a)-(f) "
        f"against the runs above (card: {card})")
    resilience = resilience_phase(cfg, params, serving, paged)
    log(f"  disaggregated serving of full-width {cfg.name} (bf16): 1 + 1 "
        f"pods, pp = 1, (a)-(e) against the runs above (card: {card})")
    t0 = time.perf_counter()
    disagg = disagg_phase(cfg, params, serving, paged, card)
    log(f"  disaggregated phase: {time.perf_counter() - t0:.1f} s")
    log(f"  the mesh: full-width {cfg.name} served over (1, 2) and (2, 2) "
        f"meshes of four logical devices on the one card (each shard its "
        f"own launch), its shard sites checked and timed, MoE and SSM "
        f"decode steps at tp {MESH_TP} (card: {card})")
    mesh = mesh_phase(cfg, params, serving, card)
    for name, err in mesh.pop("max_err").items():
        max_err[name] = max(max_err.get(name, 0.0), err)
    log(f"  the pipeline: DisaggServingEngine, {PP} + {PP} pods at pp = "
        f"{PP} over four logical devices (card: {card})")
    pp = pp_phase(cfg, params, serving, card)
    log(f"  serving full-width {moe_cfg.name} (bf16 parameters): arrayflex "
        f"at {moe_cfg.n_layers} layers, the int8 backends at "
        f"{MOE_QUANT_LAYERS}")
    moe_serving = moe_serving_phase(moe_cfg)
    log(f"  serving full-width {ssm_cfg.name} (bf16 parameters, token "
        f"prefill) on arrayflex, arrayflex_int8 and arrayflex_w8a8, then "
        f"one resilient run (card: {card})")
    ssm_serving, ssm_runs, ssm_params = ssm_serving_phase(ssm_cfg)

    log(f"[6/8] full-sequence lm.prefill of full-width {cfg.name} on "
        f"arrayflex/bf16 at S = {', '.join(map(str, FWD_SEQS))}")
    prefill = forward_phase(cfg, params)
    log(f"  K1/K2 at the prefill's site shapes (bf16 timed; card: {card})")
    prefill_sites_rows, prefill_totals = prefill_kernel_phase(cfg)
    log(f"  full-sequence lm.prefill of full-width {ssm_cfg.name} on "
        f"arrayflex/bf16 at S = {SSM_FWD_SEQ}")
    ssm_prefill = forward_phase(ssm_cfg, ssm_params, (SSM_FWD_SEQ,))

    log("[7/8] model parity: arrayflex vs ref on the card")
    parity = parity_phase(cfg, params)
    log("  quantized backends (fp32)")
    quant_parity = quant_parity_phase(cfg, params)
    fp32_runs = list(quant_parity.pop("launches").values())
    parity.update(quant_parity)
    log("  disaggregated serving (fp32): the prefill role's re-picked chunk "
        "against the colocated engine")
    disagg["fp32"], disagg_fp32_launches = disagg_fp32_parity(cfg, params,
                                                              card)
    fp32_runs += disagg_fp32_launches
    log(f"  full-sequence prefill (fp32) at S = "
        f"{', '.join(map(str, FWD_SEQS))}")
    forward_parity = forward_parity_phase(cfg, params)
    fp32_runs += forward_parity.pop("launches").values()
    parity.update(forward_parity)
    del params
    _free()
    log(f"  {moe_cfg.name} at full width, {MOE_PARITY_LAYERS} layers (fp32)")
    moe_parity = moe_parity_phase(moe_cfg)
    fp32_runs += moe_parity.pop("launches").values()
    log(f"  {ssm_cfg.name} at full width (fp32): decode and prefill against "
        f"ref, and one request alone")
    ssm_parity, ssm_counted = ssm_parity_phase(ssm_cfg, ssm_params)
    fp32_runs += ssm_counted
    del ssm_params
    _free()
    log(f"  reduced {HYBRID_ARCH} (fp32) against ref")
    hybrid_parity, hybrid_counted = hybrid_parity_phase()
    fp32_runs.append(hybrid_counted)

    families, family_runs = {}, []
    for arch in FAMILY_ARCHS:
        log(f"[7/8] {arch} at full width (bf16 parameters): serving on "
            f"{', '.join(BACKENDS)}, its sites checked and timed, fp32 "
            f"parity (card: {card})")
        fam, rows, errs, fam_runs, fam_fp32 = family_phase(arch)
        families[arch] = fam
        results += rows
        for name, err in errs.items():
            max_err[name] = max(max_err.get(name, 0.0), err)
        family_runs += fam_runs
        fp32_runs += fam_fp32

    log(f"[7/8] training on the xla backend (no kernel): full-width "
        f"qwen2-0.5b, mamba2-370m and qwen3-moe-30b-a3b at 2 layers, fp32 "
        f"parity against the CPU, the bit-exact restart, sharded training "
        f"over meshes of logical devices, remat, int8 gradient compression "
        f"(card: {card})")
    training = train_phase(card)

    # each GEMM form's launches over every serving run, the bf16 prefill
    # runs and the fp32 runs of phase 7 that are counted (the full-sequence
    # prefills and the W8 runs, each counted from 0); K3's over its
    # ops.attention run.  The FFMA kernels' are the launches of their form
    # not on the tensor-core kernels.
    paged_runs = list(paged.values()) + [
        {"launches": paged["arrayflex_w8a8"]["repeat_launches"]}]
    runs = (list(serving.values()) + list(moe_serving.values())
            + paged_runs + resilience["runs"] + disagg["runs"]
            + mesh.pop("runs") + pp.pop("runs")
            + list(prefill.values())
            + ssm_runs + list(ssm_prefill.values()) + family_runs
            + [{"launches": v} for v in fp32_runs])
    launches = {name: sum(run["launches"][name] for run in runs)
                for name in REPLACES}
    for tc in TC_COUNTERS:
        launches[tc[:-len("_tc")]] -= launches[tc]
    kernels, cells, chunk = summarize(results, max_err, launches)
    ssm_fwd = f"prefill S={SSM_FWD_SEQ}"
    ssm_rows = [r for r in results
                if r["phase"] == ssm_fwd and r["cell"] == SSM_ARCH]
    ssm_prefill_totals = {
        name: _step_totals([r for r in ssm_rows
                            if r["launch_name"] == name])
        for name in REPLACES
        if any(r["launch_name"] == name for r in ssm_rows)}
    kernels += k3_rows(k3, k3_launches)
    elapsed = time.perf_counter() - t_start
    report = dict(card=card, device=kind, torch=torch.__version__,
                  kernels=kernels, cells=cells, prefill_chunk=chunk,
                  sites=results,
                  kt_quantize=kt_quant, flash_attention=k3, serving=serving,
                  moe_serving=moe_serving, paged=paged,
                  resilience={k: v for k, v in resilience.items()
                              if k != "runs"},
                  disagg={k: v for k, v in disagg.items() if k != "runs"},
                  mesh=mesh, pp=pp,
                  prefill=prefill,
                  prefill_sites=prefill_sites_rows,
                  prefill_kernel_totals=prefill_totals, parity=parity,
                  moe_parity=moe_parity, ssm_serving=ssm_serving,
                  ssm_prefill=ssm_prefill,
                  ssm_prefill_kernel_totals=ssm_prefill_totals,
                  ssm_parity=ssm_parity, hybrid_parity=hybrid_parity,
                  families=families, train=training,
                  site_checks=SITE_CHECKS,
                  unlisted_flips=UNLISTED_FLIPS, seconds=elapsed)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(f"[8/8] summary ({elapsed:.1f} s)")
    for cell, forms in cells.items():
        for name, t in forms.items():
            lib = t["library_ms"]
            log(f"  {cell} {name}: kernel {t['ms']:.3f} / plain "
                f"{t['plain_ms']:.3f} / library "
                f"{'none' if lib is None else f'{lib:.3f}'} / bound "
                f"{t['bound_ms']:.4f} ms per decode step ({t['bound_by']})")
    for name, t in chunk.items():
        lib = t["library_ms"]
        quant = (f" (its quantize passes {t['quantize_ms']:.3f})"
                 if "quantize_ms" in t else "")
        log(f"  {cfg.name} prefill chunk {name}: kernel {t['ms']:.3f}"
            f"{quant} / plain {t['plain_ms']:.3f} / library "
            f"{'none' if lib is None else f'{lib:.3f}'} / bound "
            f"{t['bound_ms']:.4f} ms per prefill-chunk step "
            f"({t['bound_by']})")
    for name, t in ssm_prefill_totals.items():
        lib = t["library_ms"]
        quant = (f" (its quantize passes {t['quantize_ms']:.3f})"
                 if "quantize_ms" in t else "")
        log(f"  {ssm_cfg.name} prefill S={SSM_FWD_SEQ} {name}: kernel "
            f"{t['ms']:.3f}{quant} / plain {t['plain_ms']:.3f} / library "
            f"{'none' if lib is None else f'{lib:.3f}'} / bound "
            f"{t['bound_ms']:.4f} ms per prefill ({t['bound_by']})")
    for t in kernels[-2:]:
        log(f"  {t['name']} over its cases with a library time: kernel "
            f"{t['ms']:.3f} / plain {t['plain_ms']:.3f} / library "
            f"{t['library_ms']:.3f} / bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']})")
    if UNLISTED_FLIPS:
        raise AssertionError(
            f"{len(UNLISTED_FLIPS)} bf16 site checks exceed KERNEL_TOL by "
            f"exactly one bf16 step at a site TC_FLIP_SITES does not name "
            f"(cell, site, shape, k, err, scale): {UNLISTED_FLIPS}")
    log("kernels: " + ", ".join(k["name"] for k in kernels))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
