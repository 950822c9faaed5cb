"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100 is what it was written for), ``nvcc`` and
this checkout; imports only ``repro_torch``, torch and numpy.  Phases, any
failure of which exits non-zero:

1. device: the card's name and power limit, torch's device name and count;
2. build: every ``csrc/*.cu`` with nvcc for sm_90a, and the ``-Xptxas -v``
   register / shared-memory / spill lines;
3. kernel checks: each kernel against its plain PyTorch version at every
   site shape of full-width qwen2-0.5b's main path, at decode (M = 4) and
   at one prefill chunk, in bf16 and fp32, k in {1, 2, 4}, each epilogue
   flag at least once; then the kernel, the plain version and one PyTorch
   library call timed with CUDA events, beside the least time the card
   could take (the bound);
4. serving: full-width qwen2-0.5b with random weights (seed 0) served on
   the ``arrayflex`` backend in bf16 through ``ServingEngine``: every
   request must finish with its tokens and finite logits, and the kernel
   launch counters must equal the launches per step times the steps;
5. model parity: one ``prefill_step`` + ``decode_step`` on the kernels
   against the ``ref`` backend on the card, in bf16 and in fp32;
6. summary: one JSON line of kernel numbers, the card's name and power
   limit, and the ``{"ok": true, ...}`` line last.

Detailed results also go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import arrayflex_gemm as ag  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.kernels import build, substrate  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import Request, ServeConfig, ServingEngine  # noqa: E402
from repro_torch.serving.engine import PREFILL_CHUNK_CHOICES  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Tolerances, relative to the largest |value| of the plain version's output:
# fp32 — the kernel and the plain version differ only in the order of the
# fp32 sums over K (<= 4864 terms), far inside 1e-5; bf16 — the two fp32
# results may round to neighbouring bf16 values, one bf16 step (2^-8
# relative) at the largest magnitude.
KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8}
# Model logits, relative to max |ref logit|: fp32 (with an fp32 K/V cache,
# so no bf16 rounding enters) — summation order through 24 layers; bf16
# (bf16 cache, as served) — hidden states are rounded to bf16 after every
# GEMM, so a one-step rounding flip in an early layer propagates: 16 bf16
# steps.
MODEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 16 * 2.0 ** -8}

BATCH, MAX_SEQ, MAX_NEW = 4, 256, 16
PROMPT_LENS = (32, 64, 96, 128)


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


def main_path_sites(cfg, rows: int):
    """Every GEMM one step of the main path launches, with ``rows`` token
    rows per dispatch (B at decode, B * chunk at prefill)."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    L, V, ff = cfg.n_layers, cfg.padded_vocab, cfg.d_ff
    g, S = H // KV, rows // BATCH
    qkv = dict(bias=True, norm_scale=True)
    return [
        Site("attn.wq", "arrayflex_gemm", (rows, d, H * hd), L, qkv),
        Site("attn.wk", "arrayflex_gemm", (rows, d, KV * hd), L, qkv),
        Site("attn.wv", "arrayflex_gemm", (rows, d, KV * hd), L, qkv),
        Site("attn.wo", "arrayflex_gemm", (rows, H * hd, d), L),
        Site("mlp.wi_gate+mlp.wi_up", "arrayflex_gemm", (rows, d, ff), L,
             dict(dual=True, activation="silu", norm_scale=True)),
        Site("mlp.wo", "arrayflex_gemm", (rows, ff, d), L,
             dict(residual=True)),
        # prefill unembeds only each row's last token: B rows
        Site("unembed", "arrayflex_gemm", (BATCH, d, V), 1,
             dict(out_f32=True), copies=1),
        Site("attn.qk", "arrayflex_expert_gemm",
             (BATCH * KV, g * S, hd, MAX_SEQ), L, dict(out_f32=True)),
        Site("attn.pv", "arrayflex_expert_gemm",
             (BATCH * KV, g * S, MAX_SEQ, hd), L),
    ]


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
        ws = [rnd(E, K, N, dtype=torch.bfloat16) if dt == torch.float32
              and site.name == "attn.qk" else rnd(E, K, N)
              for _ in range(copies)]
        out = torch.float32 if f.get("out_f32") else None
        return x, [dict(w=w, out_dtype=out) for w in ws]
    M, K, N = site.shape
    x = rnd(M, K, scale=1.0)
    calls = []
    for _ in range(copies):
        kw = dict(w=rnd(K, N, scale=K ** -0.5))
        if f.get("dual"):
            kw["w2"] = rnd(K, N, scale=K ** -0.5)
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
    port never calls it): torch.matmul / torch.bmm, the dual pair as one
    matmul against the concatenated weights."""
    w = kw["w"]
    if "w2" in kw:
        w = torch.cat([kw["w"], kw["w2"]], dim=1)
    if site.kernel == "arrayflex_expert_gemm":
        return lambda: torch.bmm(x, w.to(x.dtype))
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


def _bound(site: Site, x, kw, out_dtype, dt):
    """(bound_ms, bound_by, bytes, ops): each input read once, the output
    written once, against the operations at the operands' peak rate."""
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
    t_ops = ops_ / PEAK_OPS_PER_S[dt] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", byts, ops_)


def check_site(site: Site, dt, gen, k: int) -> float:
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
    tol = KERNEL_TOL[dt] * max(scale, 1.0)
    if not (err <= tol) or got.shape != want.shape:
        raise AssertionError(
            f"{site.name} {site.shape} {dt} k={k}: max abs err {err} > "
            f"tol {tol} (scale {scale})")
    return err


def time_site(site: Site, gen, iters: int):
    """Kernel, plain and library times (ms per launch) at bf16, the main
    path's dtype, at the k the substrate plans for this site."""
    dt = torch.bfloat16
    fn, plain = _kernel_fns(site)
    x, calls = _operands(site, dt, gen, site.copies)
    if site.kernel == "arrayflex_expert_gemm":
        E, T, K, N = site.shape
        k = substrate.plan_gemm(N, K, T, "arrayflex").k
    else:
        M, K, N = site.shape
        f = site.flags
        ep = substrate.Epilogue(
            kind="swiglu" if f.get("dual") else f.get("activation", "none"),
            bias=bool(f.get("bias")), bias2=bool(f.get("bias2")),
            residual=bool(f.get("residual")),
            norm_scale=bool(f.get("norm_scale")))
        k = substrate.plan_gemm(N, K, M, "arrayflex", ep).k

    def bind(f_, kw):
        kw = dict(kw)
        w = kw.pop("w")
        return lambda: f_(x, w, k_collapse=k, **kw)

    ms, eager_ms = _time_ms([bind(fn, kw) for kw in calls], iters)
    plain_ms, plain_eager_ms = _time_ms([bind(plain, kw) for kw in calls],
                                        iters)
    lib_ms, lib_eager_ms = _time_ms(
        [_library_call(site, x, kw) for kw in calls], iters)
    out_dtype = calls[0].get("out_dtype") or dt
    bound_ms, bound_by, byts, ops_ = _bound(site, x, calls[0], out_dtype, dt)
    return dict(k=k, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                eager_ms=eager_ms, plain_eager_ms=plain_eager_ms,
                library_eager_ms=lib_eager_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes=byts, ops=ops_)


def kernel_phase(cfg, chunk: int):
    gen = torch.Generator(device="cuda").manual_seed(0)
    results, max_err = [], {name: 0.0 for name in ag.LAUNCHES}
    for phase, rows in (("decode", BATCH), ("prefill", BATCH * chunk)):
        for site in main_path_sites(cfg, rows):
            errs = {}
            for dt in (torch.bfloat16, torch.float32):
                for k in (1, 2, 4):
                    errs[f"{dt}".split(".")[-1] + f"/k{k}"] = check_site(
                        site, dt, gen, k)
            bf16_err = max(v for key, v in errs.items()
                           if key.startswith("bfloat16"))
            if phase == "decode":
                max_err[site.kernel] = max(max_err[site.kernel], bf16_err)
            iters = 10 if site.name == "unembed" else 2 * site.copies
            t = time_site(site, gen, iters)
            row = dict(phase=phase, site=site.name, kernel=site.kernel,
                       shape=site.shape, per_step=site.per_step,
                       max_abs_err=errs, **t)
            results.append(row)
            log(f"  {phase:7s} {site.name:22s} {str(site.shape):26s} "
                f"k={t['k']} kernel {t['ms']*1e3:8.1f} us  plain "
                f"{t['plain_ms']*1e3:8.1f} us  library "
                f"{t['library_ms']*1e3:8.1f} us  bound "
                f"{t['bound_ms']*1e3:7.2f} us ({t['bound_by']})  eager "
                f"kernel/plain/library {t['eager_ms']*1e3:.1f}/"
                f"{t['plain_eager_ms']*1e3:.1f}/"
                f"{t['library_eager_ms']*1e3:.1f} us  "
                f"bf16 err {bf16_err:.3g}")
    for name, flags in EXTRA_FLAGS:
        site = Site(name, "arrayflex_gemm", (BATCH, cfg.d_model, cfg.d_ff),
                    0, flags)
        for dt in (torch.bfloat16, torch.float32):
            for k in (1, 2, 4):
                check_site(site, dt, gen, k)
        log(f"  checked {name} in bf16/fp32 at k=1,2,4")
    return results, max_err


# ---------------------------------------------------------------------------
# phase 4: serving

def serving_phase(cfg, params):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    sc = ServeConfig(max_batch=BATCH, max_seq=MAX_SEQ, seed=0)
    # warm-up engine: first-call costs (allocator, cuBLAS handles) are not
    # the serving numbers
    warm = ServingEngine(cfg, params, sc)
    warm.submit(Request(prompt=prompts[0][:8], max_new_tokens=2))
    warm.run_to_completion()
    del warm
    engine = ServingEngine(cfg, params, sc)
    reqs = [Request(prompt=p, max_new_tokens=MAX_NEW, rid=i)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    substrate.DISPATCH_COUNTS.clear()
    ag.reset_launches()                     # counts: 0 just before the run
    t0 = time.perf_counter()
    ticks = engine.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ag.LAUNCHES)            # read just after the run
    dispatches = dict(substrate.DISPATCH_COUNTS)
    st = engine.stats
    steps = st["prefill_dispatches"] + st["decode_dispatches"]
    L = cfg.n_layers
    want = {"arrayflex_gemm": (6 * L + 1) * steps,
            "arrayflex_expert_gemm": 2 * L * steps}
    for r in reqs:
        if not r.done or len(r.out_tokens) != MAX_NEW:
            raise AssertionError(f"request {r.rid}: done={r.done}, "
                                 f"{len(r.out_tokens)} of {MAX_NEW} tokens")
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != expected "
                             f"{want} ({steps} steps of {L} layers)")
    ttft = [r.ttft_s for r in reqs]
    out = dict(
        requests=len(reqs), prompt_lens=list(PROMPT_LENS), max_new=MAX_NEW,
        ticks=ticks, wall_s=wall,
        tokens_per_s=sum(len(r.out_tokens) for r in reqs) / wall,
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
    log(f"  {out['tokens_per_s']:.1f} tok/s over {wall:.3f} s, {ticks} "
        f"ticks; prefill {st['prefill_tokens']} tok in "
        f"{st['prefill_time_s']:.4f} s ({st['prefill_dispatches']} "
        f"dispatches, chunk {engine.prefill_chunk}); decode "
        f"{st['decode_tokens']} tok in {st['decode_time_s']:.4f} s "
        f"({out['decode_step_ms']:.2f} ms/step); mean TTFT "
        f"{out['mean_ttft_ms']:.1f} ms; max memory allocated "
        f"{out['max_memory_allocated_bytes'] / 2**30:.2f} GiB")
    log(f"  launches {launches} == (6L+1, 2L) x {steps} steps")
    out["profile"] = profile_decode_step(cfg, engine, out["decode_step_ms"])
    return out


def profile_decode_step(cfg, engine, step_ms: float):
    """Device busy time of one full-batch decode step (torch.profiler,
    summed self device time), against the engine's measured step time."""
    from torch.profiler import ProfilerActivity, profile
    toks = torch.zeros(BATCH, dtype=torch.int64, device="cuda")
    pos = torch.full((BATCH,), MAX_SEQ // 2, dtype=torch.int64,
                     device="cuda")
    lm.decode_step(cfg, engine.params, engine.cache, toks, pos)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lm.decode_step(cfg, engine.params, engine.cache, toks, pos)
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    evs = [e for e in prof.key_averages() if dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in evs) / 1e3
    top = sorted(evs, key=dev_us, reverse=True)[:6]
    out = dict(device_busy_ms=busy_ms, step_ms=step_ms,
               idle_share=(1.0 - busy_ms / step_ms) if busy_ms else None,
               top=[(e.key[:160], dev_us(e) / 1e3, e.count) for e in top])
    if busy_ms:
        log(f"  profiler: device busy {busy_ms:.2f} ms of a {step_ms:.2f} "
            f"ms decode step (idle share {out['idle_share']:.2f})")
        for name, ms, n in out["top"]:
            log(f"    {ms:8.3f} ms  x{n:4d}  {name}")
    else:
        log("  profiler: no device time recorded (not measured)")
    return out


# ---------------------------------------------------------------------------
# phase 5: model parity on the card

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


def summarize(results, max_err, launches):
    """One row per kernel for one decode step at the main path's shapes:
    each site's per-launch time (device time from the graph replay; the
    plain version's and the library call's likewise) and bound, times the
    site's launches per step, summed over the sites."""
    rows = []
    src = "src/repro_torch/kernels/csrc/arrayflex_gemm.cu"
    replaces = {"arrayflex_gemm": "src/repro/kernels/arrayflex_gemm.py:177",
                "arrayflex_expert_gemm":
                    "src/repro/kernels/arrayflex_gemm.py:452"}
    for name in ("arrayflex_gemm", "arrayflex_expert_gemm"):
        sel = [r for r in results if r["kernel"] == name
               and r["phase"] == "decode"]
        tot = {key: sum(r[key] * r["per_step"] for r in sel)
               for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        byts = sum(r["bytes"] * r["per_step"] for r in sel)
        ops_ = sum(r["ops"] * r["per_step"] for r in sel)
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=replaces[name],
            launches=launches[name], max_abs_err=max_err[name],
            ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
            bound_by=("bytes" if byts / HBM_BYTES_PER_S
                      >= ops_ / PEAK_OPS_PER_S[torch.bfloat16]
                      else "operations"),
            library_ms=tot["library_ms"]))
    return rows


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false — "
                         "this script runs on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"[1/6] device: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {kind} x {count}")

    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"[2/6] build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for stem, text in build.PTXAS_INFO.items():
        for line in text.splitlines():
            if "Compiling entry" in line or "Used" in line \
                    or "spill" in line:
                log(f"  {stem}: {line.strip()}")

    cfg = dataclasses.replace(get_config("qwen2-0.5b"),
                              gemm_backend="arrayflex",
                              compute_dtype="bfloat16")
    chunk = min(MAX_SEQ, planner.attention_plan(
        MAX_SEQ, MAX_SEQ, choices=PREFILL_CHUNK_CHOICES))
    log(f"[3/6] kernel checks and times (bf16; per call: device time from "
        f"a CUDA-graph replay, eager time with host launches; card: {card})")
    results, max_err = kernel_phase(cfg, chunk)

    log(f"[4/6] serving full-width {cfg.name} on arrayflex/bf16")
    params = lm.init_params(cfg, seed=0)
    serving = serving_phase(cfg, params)

    log("[5/6] model parity: arrayflex vs ref on the card")
    parity = parity_phase(cfg, params)

    kernels = summarize(results, max_err, serving["launches"])
    elapsed = time.perf_counter() - t_start
    report = dict(card=card, device=kind, torch=torch.__version__,
                  kernels=kernels, sites=results, serving=serving,
                  parity=parity, seconds=elapsed)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(f"[6/6] summary ({elapsed:.1f} s)")
    log("kernels: " + ", ".join(k["name"] for k in kernels))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
