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
   each), in bf16 and fp32, k in {1, 2, 4}, each epilogue flag at least
   once; then the kernel, the plain version and one PyTorch library call
   timed with CUDA events, beside the least time the card could take (the
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
   together): every request must finish with its tokens and finite
   logits, and each run's kernel launch counters (set to 0 just before
   it) must equal its forms' launches per step times the steps, every
   bf16 K1 and K2 launch (the W8 K1's too) on the tensor-core kernels;
6. full-sequence prefill: full-width qwen2-0.5b ``lm.prefill`` on
   ``arrayflex``/bf16, B = 1, at S = 2048 (dense attention: attn.qk on K2
   at g * S = 14336 rows) and S = 4096 (the chunked scan), each run's
   launch counters set to 0 just before it and read just after (K1 and K2
   per layer, never K3; every launch on the tensor-core kernels), with
   its host-clock time, device-busy time and peak memory;
7. model parity: one ``prefill_step`` + ``decode_step`` on the kernels
   against the ``ref`` backend on the card, in bf16 and in fp32; then
   ``arrayflex_int8`` against ``ref`` on the dequantized weights (its
   launch counters set to 0 just before and read just after: every W8 K1
   launch on the FFMA kernel), and ``arrayflex_w8a8`` against fp32
   ``arrayflex``, both in fp32; then the
   full-width prefill of phase 6 in fp32 against ``ref`` and against the
   engine's chunked ``prefill_step`` path on the same tokens (the kernels'
   run with its launch counters set to 0 just before and read just after:
   every launch on the FFMA kernels); then the
   same three decode pairs on qwen3-moe-30b-a3b in fp32 at full width and
   4 layers, and its ``lm.prefill`` at S = 256 on the kernels against
   ``ref``, each reporting whether both runs routed every token to the
   same experts at every layer (the W8 run counted as above); the fp32
   runs launch the FFMA K1 only;
8. summary: each form's totals per decode step of each model and per
   prefill-chunk step of qwen2-0.5b, one JSON line of kernel numbers, the
   card's name and power limit, and the ``{"ok": true, ...}`` line last.

Detailed results also go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import arrayflex_gemm as ag  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.kernels import build, ops, substrate  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.nn import moe  # noqa: E402
from repro_torch.serving import Request, ServeConfig, ServingEngine  # noqa: E402
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
}


def kernel_tol(site, dt, scale: float) -> float:
    """Absolute tolerance of a decode / prefill-chunk site's check: the
    int8 forms and TC_FLIP_SITES take :func:`step_tol`; the other float
    sites keep KERNEL_TOL."""
    if site.form != "float" or (site.cell, site.name,
                                tuple(site.shape)) in TC_FLIP_SITES:
        return step_tol(dt, scale)
    return KERNEL_TOL[dt] * max(scale, 1.0)
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
    if not (err <= tol) or got.shape != want.shape:
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
    k = planned_k(site)

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


def kernel_phase(cfg, moe_cfg, chunk: int, form: str = "float"):
    """Check and time every site of ``form`` (the float sites of the
    arrayflex path, or the int8 sites of a quantizing backend's path) on
    the dense model ``cfg`` at decode and at the prefill chunk, and on the
    MoE model ``moe_cfg`` at decode (its prefill runs decode steps)."""
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

def expected_launches(cfg, steps: int):
    """Kernel launches of ``steps`` engine steps of ``cfg`` on its backend,
    per form: per layer the attention projections (and a dense MLP's two
    GEMMs) on the backend's K1 form, an MoE router on the float K1, the
    three expert banks on the backend's K2 form, attn.qk on K2 (its W8A8
    form under W8A8) and attn.pv on the float K2; the unembed once."""
    L, be = cfg.n_layers, cfg.gemm_backend
    suffix = {"arrayflex": "", "arrayflex_int8": "_int8",
              "arrayflex_w8a8": "_w8a8"}[be]
    is_moe = cfg.moe is not None
    want = {name: 0 for name in ag.LAUNCHES}
    want["arrayflex_gemm" + suffix] += (4 * L + 1 + (0 if is_moe else 2 * L)) \
        * steps
    if be != "arrayflex_w8a8" and cfg.compute_dtype == "bfloat16":
        # every bf16 K1 launch, float or W8, on the tensor-core kernel (the
        # fp32 MoE router stays on the FFMA kernel)
        want["arrayflex_gemm" + suffix + "_tc"] = \
            want["arrayflex_gemm" + suffix]
    if is_moe:
        want["arrayflex_gemm"] += L * steps                     # router
        want["arrayflex_expert_gemm" + suffix] += 3 * L * steps  # banks
    qk = ("arrayflex_expert_gemm_w8a8" if be == "arrayflex_w8a8"
          else "arrayflex_expert_gemm")
    want[qk] += L * steps
    want["arrayflex_expert_gemm"] += L * steps                  # attn.pv
    if cfg.compute_dtype == "bfloat16":
        # every float K2 launch (bf16 cache, bf16 banks) on the tensor-core
        # kernel, on every backend
        want["arrayflex_expert_gemm_tc"] = want["arrayflex_expert_gemm"]
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


def serving_phase(cfg, params, prompt_lens=PROMPT_LENS, max_new=MAX_NEW,
                  max_seq=MAX_SEQ):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in prompt_lens]
    sc = ServeConfig(max_batch=BATCH, max_seq=max_seq, seed=0)
    # warm-up engine: first-call costs (allocator, cuBLAS handles) are not
    # the serving numbers
    warm = ServingEngine(cfg, params, sc)
    warm.submit(Request(prompt=prompts[0][:8], max_new_tokens=2))
    warm.run_to_completion()
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
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
        launches=launches, dispatch_counts=dispatches,
        prefill_chunk=engine.prefill_chunk,
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
# phase 6: full-sequence prefill

# prompt lengths of the full-sequence prefill (B = 1): the last one at or
# below qwen2-0.5b's attn_dense_below (dense attention), and one above it
# (the chunked scan)
FWD_SEQS = (2048, 4096)


def forward_launches(cfg, S: int):
    """Kernel launches of one ``lm.prefill`` of ``cfg`` (a dense model on
    ``arrayflex``) at S tokens: per layer 6 K1 launches (q, k, v, o, the
    dual-GEMM swiglu, mlp.wo) and, on the dense attention path, attn.qk
    and attn.pv on K2; the unembed once.  K3 is never on the model path."""
    L = cfg.n_layers
    want = {name: 0 for name in list(ag.LAUNCHES) + list(fa.LAUNCHES)}
    want["arrayflex_gemm"] = 6 * L + 1
    if S <= cfg.attn_dense_below:
        want["arrayflex_expert_gemm"] = 2 * L
    if cfg.compute_dtype == "bfloat16":              # all on tensor cores
        want["arrayflex_gemm_tc"] = want["arrayflex_gemm"]
        want["arrayflex_expert_gemm_tc"] = want["arrayflex_expert_gemm"]
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


def forward_phase(cfg, params):
    """Full-width ``lm.prefill`` at each of FWD_SEQS (B = 1, the served
    bf16 tree): host-clock time of the run whose counters are checked,
    device busy time of another (profiler), peak memory, logits and cache
    shapes."""
    served = lm.prepare_params(cfg, params)
    rng = np.random.default_rng(4)
    out = {}
    for S in FWD_SEQS:
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
        check_launches(f"prefill S={S}", launches, forward_launches(cfg, S))
        kv = (lm.n_super(cfg), 1, S, cfg.n_kv_heads, cfg.resolved_head_dim)
        if (tuple(logits.shape) != (1, cfg.padded_vocab)
                or not bool(torch.isfinite(logits).all())
                or any(tuple(c[n].shape) != kv for c in caches
                       for n in ("k", "v"))):
            raise AssertionError(f"prefill S={S}: logits "
                                 f"{tuple(logits.shape)} or caches wrong, "
                                 f"or non-finite logits")
        del logits, caches
        path = "dense" if S <= cfg.attn_dense_below else "chunked"
        log(f"  {cfg.name} x{cfg.n_layers} lm.prefill B=1 S={S} ({path} "
            f"attention): {wall_ms:.1f} ms host clock, peak "
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
    chunk = min(MAX_SEQ, planner.attention_plan(
        MAX_SEQ, MAX_SEQ, choices=PREFILL_CHUNK_CHOICES))
    tc_report(cfg, moe_cfg, chunk)
    log(f"[3/8] GEMM kernel checks and times (bf16, the MoE router fp32; "
        f"per call: device time from a CUDA-graph replay, eager time with "
        f"host launches; card: {card})")
    results, max_err = kernel_phase(cfg, moe_cfg, chunk)
    for form in ("int8", "w8a8"):
        r, e = kernel_phase(cfg, moe_cfg, chunk, form)
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
    log(f"  serving full-width {moe_cfg.name} (bf16 parameters): arrayflex "
        f"at {moe_cfg.n_layers} layers, the int8 backends at "
        f"{MOE_QUANT_LAYERS}")
    moe_serving = moe_serving_phase(moe_cfg)

    log(f"[6/8] full-sequence lm.prefill of full-width {cfg.name} on "
        f"arrayflex/bf16 at S = {', '.join(map(str, FWD_SEQS))}")
    prefill = forward_phase(cfg, params)
    log(f"  K1/K2 at the prefill's site shapes (bf16 timed; card: {card})")
    prefill_sites_rows, prefill_totals = prefill_kernel_phase(cfg)

    log("[7/8] model parity: arrayflex vs ref on the card")
    parity = parity_phase(cfg, params)
    log("  quantized backends (fp32)")
    quant_parity = quant_parity_phase(cfg, params)
    fp32_runs = list(quant_parity.pop("launches").values())
    parity.update(quant_parity)
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

    # each GEMM form's launches over every serving run, the bf16 prefill
    # runs and the fp32 runs of phase 7 that are counted (the full-sequence
    # prefills and the W8 runs, each counted from 0); K3's over its
    # ops.attention run.  The FFMA kernels' are the launches of their form
    # not on the tensor-core kernels.
    runs = (list(serving.values()) + list(moe_serving.values())
            + list(prefill.values()) + [{"launches": v} for v in fp32_runs])
    launches = {name: sum(run["launches"][name] for run in runs)
                for name in REPLACES}
    for tc in TC_COUNTERS:
        launches[tc[:-len("_tc")]] -= launches[tc]
    kernels, cells, chunk = summarize(results, max_err, launches)
    kernels += k3_rows(k3, k3_launches)
    elapsed = time.perf_counter() - t_start
    report = dict(card=card, device=kind, torch=torch.__version__,
                  kernels=kernels, cells=cells, prefill_chunk=chunk,
                  sites=results,
                  kt_quantize=kt_quant, flash_attention=k3, serving=serving,
                  moe_serving=moe_serving, prefill=prefill,
                  prefill_sites=prefill_sites_rows,
                  prefill_kernel_totals=prefill_totals, parity=parity,
                  moe_parity=moe_parity, seconds=elapsed)
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
    for t in kernels[-2:]:
        log(f"  {t['name']} over its cases with a library time: kernel "
            f"{t['ms']:.3f} / plain {t['plain_ms']:.3f} / library "
            f"{t['library_ms']:.3f} / bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']})")
    log("kernels: " + ", ".join(k["name"] for k in kernels))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
