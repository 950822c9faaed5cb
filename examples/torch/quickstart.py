"""Quickstart: the ArrayFlex core in five minutes, on the PyTorch port.

1. Reproduce the paper's headline numbers (latency/power/EDP vs a fixed
   pipeline SA) on the three evaluated CNNs.
2. Run the cycle-accurate simulator (bit-exact carry-save datapath).
3. Plan + execute a GEMM through the CUDA kernel with the planner's k
   (bf16 operands: K1's tensor-core form).
4. Run a whole transformer with every GEMM dispatched through the
   ArrayFlex substrate (gemm_backend="arrayflex": K1 and K2 in fp32).
5. Quantize to int8 weights (gemm_backend="arrayflex_int8"): the int8
   datapath re-picks the collapse depth per layer.
6. Audit the substrate contract: one call proves every GEMM in the
   model's forward / decode / prefill routes through the planner (and
   shows what a violation looks like).
7. Serve with a paged K/V cache (`--kv-pages` on repro_torch.launch.serve):
   block-table paged attention with planner-picked page geometry and
   radix prefix reuse — more resident sequences than max_batch, shared
   system prompts prefilled once, streams identical to the dense cache.
8. Go W8A8 (gemm_backend="arrayflex_w8a8"): dynamic per-tile activation
   quantization in the kernel's prologue engages the int8 x int8 -> int32
   MAC path, and the Eq.(5') activation-quantize boundary term alone
   re-picks the collapse depth at the pinned decode shape.
9. Disaggregate prefill from decode (DisaggServingEngine): the two
   phases run as separate roles with opposite plan objectives — the
   stage-boundary transfer deepens prefill's collapse depth and shallows
   decode's — while the K/V handoff keeps greedy streams identical to
   the colocated engine.

Runs on the card unless ``--device cpu`` is given (the kernels' plain
PyTorch versions); without a card the default raises.  ``run`` returns
what ``main`` prints as a dict: ``lines`` (the printed lines) and the
numbers behind them.

Run:  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.analysis import dispatch_audit
from repro_torch.configs import get_config, reduced
from repro_torch.core import cnn_shapes, planner, simulator, timing
from repro_torch.kernels import arrayflex_gemm as ag
from repro_torch.kernels import ops, ref, substrate
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import lm
from repro_torch.parallel import sharding
from repro_torch.serving import (DisaggServeConfig, DisaggServingEngine,
                                 ServeConfig, ServingEngine)
from repro_torch.serving.engine import Request

def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _counted(dev, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` and what it did: substrate dispatches and
    kernel launches per form (deltas of ``DISPATCH_COUNTS`` and
    ``arrayflex_gemm.LAUNCHES``; the ``*_tc`` counters are subsets of
    their form's, so the launches sum the rest)."""
    d0 = sum(substrate.DISPATCH_COUNTS.values())
    l0 = dict(ag.LAUNCHES)
    out = fn(*args, **kwargs)
    _sync(dev)
    launches = {k: v - l0[k] for k, v in ag.LAUNCHES.items() if v - l0[k]}
    return out, dict(dispatches=sum(substrate.DISPATCH_COUNTS.values()) - d0,
                     launches=launches,
                     kernel_launches=sum(v for k, v in launches.items()
                                         if not k.endswith("_tc")))


def run(device="cuda", params=None, log=print):
    """The nine steps on ``device``; each printed line goes to ``log``.
    ``params``: the parameter tree of reduced qwen2-0.5b (default
    ``lm.init_params(seed=0)``).  Returns the lines and the numbers."""
    dev = resolve_device(device)
    out = {"lines": [], "steps": {}}

    def emit(line=""):
        out["lines"].append(line)
        log(line)

    # a fresh process's memos: the per-site plan log below is this run's
    substrate.clear_plan_cache()
    substrate.clear_quant_cache()

    # -- 1. the paper's evaluation ---------------------------------------
    emit("=== ArrayFlex vs conventional SA (paper Figs. 8/9) ===")
    out["paper"] = {}
    for net in ("resnet34", "mobilenet", "convnext"):
        gemms = [planner.GEMM(f"l{i}", *mnt)
                 for i, mnt in enumerate(cnn_shapes.network_mnt(net))]
        res = planner.plan_network(gemms, 128, 128)
        out["paper"][net] = {k: res[k] for k in ("latency_saving",
                                                 "power_saving", "edp_gain")}
        emit(f"  {net:10s}: latency -{res['latency_saving']*100:4.1f}%  "
             f"power -{res['power_saving']*100:4.1f}%  "
             f"EDP {res['edp_gain']:.2f}x")

    # -- 2. cycle-accurate simulation ------------------------------------
    emit("\n=== Simulator: ResNet-34 layer 28 tile on a 16x16 array ===")
    rng = np.random.RandomState(0)
    A = torch.as_tensor(rng.randint(-128, 127, (12, 16)),
                        dtype=torch.int32, device=dev)
    B = torch.as_tensor(rng.randint(-128, 127, (16, 16)),
                        dtype=torch.int32, device=dev)
    out["simulator"] = {}
    for k in (1, 2, 4):
        X, cycles = simulator.simulate_tile(A, B, k)
        ok = np.array_equal(X.cpu().numpy(),
                            A.cpu().numpy() @ B.cpu().numpy())
        period = timing.DEFAULT_TIMING.clock_period_ps(k)
        out["simulator"][k] = dict(cycles=cycles, exact=ok)
        emit(f"  k={k}: {cycles:3d} cycles x {period:5.1f} ps = "
             f"{cycles*period/1000:6.2f} ns   exact={ok}")

    # -- 3. planner-driven GEMM kernel -----------------------------------
    emit("\n=== " + ("CUDA kernel" if dev.type == "cuda" else
                     "CUDA kernel's plain version (CPU)")
         + " with planned collapse ===")
    x = torch.as_tensor(rng.randn(256, 1024), device=dev).to(torch.bfloat16)
    w = torch.as_tensor(rng.randn(1024, 512), device=dev).to(torch.bfloat16)
    k = ops.plan_collapse(512, 1024, 256)
    y, counts = _counted(dev, ops.arrayflex_matmul, x, w, k_collapse=k)
    want = ref.gemm_ref(x, w).float()
    err = float(torch.max(torch.abs(y.float() - want)))
    out["steps"]["gemm"] = counts
    out["gemm"] = dict(k=k, err=err, scale=float(torch.max(torch.abs(want))))
    emit(f"  planned k={k}; kernel vs oracle max err {err:.3e}")

    # -- 4. whole model through the substrate ----------------------------
    emit("\n=== Transformer GEMMs through the ArrayFlex substrate ===")
    cfg = reduced(get_config("qwen2-0.5b"), compute_dtype="float32",
                  param_dtype="float32")
    cfg_af = reduced(get_config("qwen2-0.5b"), compute_dtype="float32",
                     param_dtype="float32", gemm_backend="arrayflex")
    if params is None:
        params = lm.init_params(cfg, seed=0, device=dev)
    toks = torch.as_tensor(rng.randint(2, cfg.vocab_size, (2, 12)),
                           device=dev)
    with torch.no_grad():
        lx, _, _ = lm.forward(cfg, params, {"tokens": toks})
        (la, _, _), counts = _counted(dev, lm.forward, cfg_af, params,
                                      {"tokens": toks})
    out["steps"]["arrayflex"] = counts
    out["logits_diff"] = {"arrayflex": float(torch.max(torch.abs(lx - la))),
                          "scale": float(torch.max(torch.abs(lx)))}
    emit(f"  xla vs arrayflex logits max diff "
         f"{out['logits_diff']['arrayflex']:.3e}")
    emit("  per-site plans (planner Eq.6 selections driving execution):")
    out["site_plans"] = {}
    for site, p in sorted(substrate.SITE_PLANS.items()):
        out["site_plans"][site] = (p.M, p.N, p.T, p.k)
        emit(f"    {site:12s} M={p.M:4d} N={p.N:4d} T={p.T:4d} -> k={p.k} "
             f"(predicted saving {100 * p.saving:4.1f}%)")

    # -- 5. quantized int8 backend ---------------------------------------
    emit("\n=== Int8 weights, fp32 accumulation, int8-planned k ===")
    cfg_i8 = reduced(get_config("qwen2-0.5b"), compute_dtype="float32",
                     param_dtype="float32", gemm_backend="arrayflex_int8")
    substrate.clear_quant_cache()
    with torch.no_grad():
        (l8, _, _), counts = _counted(dev, lm.forward, cfg_i8, params,
                                      {"tokens": toks})
    out["steps"]["arrayflex_int8"] = counts
    out["logits_diff"]["arrayflex_int8"] = float(torch.max(torch.abs(la - l8)))
    emit(f"  fp32-arrayflex vs int8 logits max diff "
         f"{out['logits_diff']['arrayflex_int8']:.3e} "
         f"(documented tolerance 0.06: quantization noise only)")
    out["quant_memo"] = substrate.quantize_cache_info()
    emit(f"  weight-quantize memo: {out['quant_memo']}")
    # the per-layer reconfiguration the paper argues for: the SAME shape
    # plans a different collapse depth per datapath precision
    M, N, T = 896, 4864, 512        # qwen2-0.5b mlp.wo, 512-row decode
    k_fp = ops.plan_collapse(M, N, T)
    k_i8 = ops.plan_collapse(M, N, T, precision="int8")
    pf = substrate.plan_gemm(M, N, T, "arrayflex")
    p8 = substrate.plan_gemm(M, N, T, "arrayflex_int8")
    emit(f"  mlp.wo (M={M}, N={N}, T={T}): fp32 k={k_fp}, int8 k={k_i8} "
         f"-> int8 Eq.(6') speedup {pf.t_pred_ps / p8.t_pred_ps:.2f}x")

    # -- 6. audit the substrate contract ---------------------------------
    emit("\n=== Static analysis: every GEMM routes through the planner ===")
    emit("  (full matrix: PYTHONPATH=src python -m repro_torch.analysis.audit)")
    substrate.clear_plan_cache()
    meta = {}
    found, counts = _counted(dev, dispatch_audit.audit_model, cfg_af,
                             label="qwen2/arrayflex", device=dev, meta=meta)
    # the audit clears the dispatch log as it ends: its entries count them
    counts["dispatches"] = sum(m["dispatches"] for m in meta.values())
    out["steps"]["audit"] = counts
    errs = [f for f in found if f.severity == "error"]
    out["audit"] = dict(errors=len(errs), warnings=len(found) - len(errs),
                        fallbacks=sum(len(m["fallbacks"])
                                      for m in meta.values()))
    emit(f"  traced forward/decode/prefill: {len(errs)} error(s) "
         f"({len(found) - len(errs)} warning(s)) -> "
         f"{'contract holds' if not errs else 'CONTRACT BROKEN'}")
    # what a violation looks like: a raw `@` GEMM that bypasses dispatch
    a, b = (torch.ones((8, 16), device=dev), torch.ones((16, 8), device=dev))
    bypass = dispatch_audit.audit_record(
        dispatch_audit.record(lambda: a @ b), label="bypass-demo")
    out["bypass"] = [f.code for f in bypass]
    for f in bypass:
        emit(f"  seeded bypass -> {f}")
    # and the runtime twin: strict mode rejects unknown site labels
    out["strict"] = ""
    with substrate.strict_audit_scope():
        try:
            substrate.gemm(torch.ones((4, 8), device=dev),
                           torch.ones((8, 4), device=dev), site="not.a.site")
        except RuntimeError as e:
            out["strict"] = str(e)
            emit(f"  strict-audit dispatch -> {e}")
    substrate.clear_plan_cache()

    # -- 7. paged-KV serving with radix prefix reuse ---------------------
    emit("\n=== Paged K/V serving (--kv-pages on repro_torch.launch.serve) ===")
    system = list(range(3, 19))                 # 16-token shared prompt
    prompts = [system + [40 + i] for i in range(5)]

    def serve(kv_pages, prefix_cache=False):
        engine = ServingEngine(cfg, params, ServeConfig(
            max_batch=2, max_seq=32, prefill_mode="batched",
            prefill_chunk=8, kv_pages=kv_pages, prefix_cache=prefix_cache),
            device=dev)
        reqs = [Request(prompt=p, max_new_tokens=3, rid=i)
                for i, p in enumerate(prompts)]
        engine.submit(reqs[0])                  # leader publishes its pages
        while not reqs[0].out_tokens:
            engine.step()
        for r in reqs[1:]:
            engine.submit(r)
        engine.run_to_completion()
        return [r.out_tokens for r in reqs], engine

    dense_out, _ = serve(0)
    paged_out, eng = serve(24, prefix_cache=True)
    st = eng.stats
    out["paged"] = dict(
        page_size=eng.page_size, n_pages=eng.pool.n_pages,
        kib=eng.kv_cache_bytes() // 1024,
        concurrency_peak=st["concurrency_peak"],
        pages_used_peak=st["pages_used_peak"],
        prefix_hit_tokens=st["prefix_hit_tokens"],
        prefill_dispatches=st["prefill_dispatches"],
        prefill_gemm_dispatches=st["prefill_gemm_dispatches"],
        dense=dense_out, paged=paged_out, identical=paged_out == dense_out)
    emit(f"  planner page_plan -> {eng.page_size} tokens/page "
         f"({eng.pool.n_pages} pages, "
         f"{eng.kv_cache_bytes() // 1024} KiB pool)")
    emit(f"  {st['concurrency_peak']} resident sequences on a "
         f"max_batch=2 engine; peak {st['pages_used_peak']} pages")
    emit(f"  prefix reuse: {st['prefix_hit_tokens']} prompt tokens "
         f"served from shared pages "
         f"({st['prefill_gemm_dispatches']} prefill GEMM launches)")
    emit(f"  paged streams identical to dense: {paged_out == dense_out}")

    # -- 8. W8A8: the int8 x int8 MAC path engages ------------------------
    emit("\n=== W8A8: dynamic per-tile activation quantization ===")
    cfg_w8 = reduced(get_config("qwen2-0.5b"), compute_dtype="float32",
                     param_dtype="float32", gemm_backend="arrayflex_w8a8")
    with torch.no_grad():
        (lw, _, _), counts = _counted(dev, lm.forward, cfg_w8, params,
                                      {"tokens": toks})
    out["steps"]["arrayflex_w8a8"] = counts
    out["logits_diff"]["arrayflex_w8a8"] = float(torch.max(torch.abs(la - lw)))
    emit(f"  fp32-arrayflex vs w8a8 logits max diff "
         f"{out['logits_diff']['arrayflex_w8a8']:.3e} "
         f"(documented tolerance 0.12: weight + activation rounding)")
    # the integer MAC path is real: the int8 x int8 contractions of one
    # W8A8 dispatch — on the card its W8A8 launches of K1, on the CPU the
    # plain version's integer products the dispatch audit records
    a = torch.ones((8, 256), dtype=torch.float32, device=dev)
    b = torch.ones((256, 32), dtype=torch.float32, device=dev)
    if dev.type == "cuda":
        _, counts = _counted(dev, substrate.gemm, a, b,
                             backend="arrayflex_w8a8")
        n_i8 = counts["launches"].get("arrayflex_gemm_w8a8", 0)
    else:
        rec = dispatch_audit.record(substrate.gemm, a, b,
                                    backend="arrayflex_w8a8")
        n_i8 = sum(1 for ev in rec.events if ev.kind == "contraction" and
                   any(fn == "_w8a8_accumulate" for _, fn in ev.frames))
    out["int8_contractions"] = n_i8
    emit(f"  int8 x int8 contractions of one W8A8 dispatch: {n_i8}")
    # Eq.(5') quantize boundary term: at the pinned decode shape the actq
    # stage ALONE deepens the argmin (w8a8 without it still picks k=2)
    k_w8_no = ops.plan_collapse(M, N, T, precision="w8a8")
    k_w8 = ops.plan_collapse(M, N, T, precision="w8a8", actq_ops=1)
    pw = substrate.plan_gemm(M, N, T, "arrayflex_w8a8")
    emit(f"  mlp.wo (M={M}, N={N}, T={T}): fp32 k={k_fp}, "
         f"w8a8-unpriced k={k_w8_no}, w8a8+actq k={k_w8} "
         f"-> Eq.(6') speedup {pf.t_pred_ps / pw.t_pred_ps:.2f}x vs fp32")
    rows = planner.precision_table(
        cfg_w8, planner.ShapeConfig("demo", 8, 2, "train"))
    r0 = rows[0]
    emit(f"  precision_table[{r0['gemm'].name}]: " + "  ".join(
        f"{p}: k={r0['plans'][p].k} t={r0['plans'][p].t_abs_ps / 1e3:.1f}ns"
        for p in ("fp32", "int8", "w8a8")))

    # -- 9. disaggregated prefill/decode serving --------------------------
    emit("\n=== Disaggregated serving (--prefill-pods / --decode-pods) ===")
    kw = dict(max_batch=2, max_seq=32, prefill_chunk=8)

    def disagg_serve(engine_cls, sc):
        engine = engine_cls(cfg, params, sc, device=dev)
        reqs = [Request(prompt=p, max_new_tokens=3, rid=i)
                for i, p in enumerate(prompts)]
        for r in reqs:
            engine.submit(r)
        engine.run_to_completion()
        return [r.out_tokens for r in reqs], engine

    colo_out, _ = disagg_serve(ServingEngine, ServeConfig(**kw))
    dis_out, deng = disagg_serve(
        DisaggServingEngine,
        DisaggServeConfig(**kw, prefill_pods=1, decode_pods=1))
    st = deng.stats
    vt = sum(deng.ttft_virtual.values()) / len(deng.ttft_virtual)
    out["disagg"] = dict(kib=st["kv_transfer_bytes"] // 1024,
                         colocated=colo_out, disagg=dis_out,
                         identical=dis_out == colo_out, virtual_ttft_s=vt,
                         boundary={})
    emit(f"  K/V handoff: {st['kv_transfer_bytes'] // 1024} KiB pod->pod "
         f"across {len(prompts)} requests")
    emit(f"  disagg streams identical to colocated: {dis_out == colo_out}")
    emit(f"  mean virtual TTFT {vt * 1e3:.1f} ms (per-role clocks: "
         f"neither role pays the other's interleaved dispatches)")
    # the per-role plan objective: at the pinned pipeline boundary site
    # the SAME shape collapses deeper on prefill pods than decode pods
    ep1 = substrate.Epilogue(kind="none", bias=True)
    for T_ in (128, 2048):
        ks = {}
        for role in ("prefill", "decode"):
            t_ops, t_cyc = sharding.pp_transfer_terms(role, 2, T_, 896)
            ks[role] = substrate.plan_gemm(
                896, 896, T_, "arrayflex", epilogue=ep1,
                shard=substrate.ShardSig(transfer_ops=t_ops,
                                         transfer_cycles=t_cyc)).k
        out["disagg"]["boundary"][T_] = ks
        emit(f"  attn.wq boundary (M=K=896, pp=2, T={T_}): "
             f"prefill k={ks['prefill']} vs decode k={ks['decode']}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu (the kernels' "
                         "plain PyTorch versions)")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
