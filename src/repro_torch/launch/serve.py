"""Serving CLI of the port: chunked batched prefill + continuous decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --requests 6 --max-new 24 --gemm-backend arrayflex

``--gemm-backend arrayflex_int8`` serves int8 weights (W8) and
``arrayflex_w8a8`` int8 weights and per-tile int8 activations (W8A8).
``--arch qwen3-moe-30b-a3b`` serves the MoE family (token-by-token
prefill), e.g. on the CPU:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch qwen3-moe-30b-a3b --gemm-backend arrayflex_int8

Runs on the card unless ``--device cpu``.  ``--reduced`` (the default)
serves the smoke-test sized config; ``--no-reduced`` serves the full
published width, with bf16 parameters (full-width qwen3-moe-30b-a3b is
61 GB in bf16, 122 GB in fp32).  ``--n-layers`` cuts the depth: a
quantizing backend holds the bf16 tree and its int8 copy at once, which
for qwen3-moe-30b-a3b fits one 80 GB card with ``--n-layers 24``.
``--kv-pages N`` serves from a paged K/V pool of N pages (the scratch page
included) instead of the dense ``(max_batch, max_seq)`` cache, with
``--page-size`` tokens a page (0: the planner's ``page_plan``) and, with
``--prefix-cache``, the radix prefix cache, e.g. on the CPU:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --gemm-backend arrayflex --kv-pages 40 --page-size 16 --prefix-cache

Prints per-request outputs plus per-phase timing: prefill and decode
throughput (tokens/s), dispatch counts, and mean time-to-first-token.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import substrate
from repro_torch.models import lm
from repro_torch.serving import Request, ServeConfig, ServingEngine


def phase_report(engine: ServingEngine, reqs) -> str:
    st = engine.stats
    pf_tps = st["prefill_tokens"] / max(st["prefill_time_s"], 1e-9)
    de_tps = st["decode_tokens"] / max(st["decode_time_s"], 1e-9)
    ttfts = [r.ttft_s for r in reqs if r.ttft_s is not None]
    ttft_ms = 1e3 * sum(ttfts) / max(len(ttfts), 1)
    out = (f"prefill[{engine.prefill_mode}]: {st['prefill_tokens']} tok "
           f"in {st['prefill_time_s']:.3f}s ({pf_tps:.1f} tok/s, "
           f"{st['prefill_dispatches']} dispatches, "
           f"chunk={engine.prefill_chunk})\n"
           f"decode: {st['decode_tokens']} tok in "
           f"{st['decode_time_s']:.3f}s ({de_tps:.1f} tok/s, "
           f"{st['decode_dispatches']} dispatches)\n"
           f"mean TTFT: {ttft_ms:.1f} ms")
    if engine.paged:
        out += (f"\npages: peak {st['pages_used_peak']} of "
                f"{engine.pool.n_pages - 1} in use, concurrency peak "
                f"{st['concurrency_peak']}, prefix hits "
                f"{st['prefix_hit_tokens']} tok")
    be = engine.cfg.gemm_backend
    if substrate.backend_quantizes(be):
        out += (f"\nquantized: {be} serves int8 weights from the "
                f"pre-quantized tree"
                + (", per-tile int8 activations in-kernel (W8A8 MAC path)"
                   if substrate.backend_act_quantizes(be)
                   else " against fp32 activations"))
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the smoke-test sized config (default); "
                         "--no-reduced serves the full published width")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="serve this many layers (0: the config's)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prefill chunk size (0 -> planner-chosen)")
    ap.add_argument("--prefill-mode", default="auto",
                    choices=("auto", "batched", "token"))
    ap.add_argument("--kv-pages", type=int, default=0,
                    help="paged K/V: physical pages in the global pool "
                         "(incl. the scratch page); 0 keeps the dense "
                         "(max_batch, max_seq) slot cache.  Admission then "
                         "reserves pages, so concurrency is memory-bounded "
                         "rather than capped at --max-batch")
    ap.add_argument("--page-size", type=int, default=0,
                    help="tokens per K/V page (must divide max_seq); "
                         "0 -> planner.page_plan picks it")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix shared-prefix reuse: requests sharing a "
                         "prompt prefix map their leading block-table "
                         "entries to the same physical pages (paged mode "
                         "only)")
    ap.add_argument("--gemm-backend", default="xla",
                    help="GEMM substrate backend (kernels.substrate): "
                         + " | ".join(substrate.backends()))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu (the kernels' "
                         "plain PyTorch versions)")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.prefix_cache and not args.kv_pages:
        ap.error("--prefix-cache requires --kv-pages (paged mode)")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    substrate.check_backend(args.gemm_backend)
    cfg = dataclasses.replace(
        cfg, gemm_backend=args.gemm_backend,
        param_dtype=cfg.param_dtype if args.reduced else "bfloat16",
        n_layers=args.n_layers or cfg.n_layers)
    params = lm.init_params(cfg, seed=0, device=args.device)
    engine = ServingEngine(cfg, params,
                           ServeConfig(max_batch=args.max_batch, max_seq=128,
                                       prefill_mode=args.prefill_mode,
                                       prefill_chunk=args.prefill_chunk,
                                       kv_pages=args.kv_pages,
                                       page_size=args.page_size,
                                       prefix_cache=args.prefix_cache),
                           device=args.device)
    if args.kv_pages:
        print(f"paged KV: {args.kv_pages} pages x {engine.page_size} tok "
              f"({engine.kv_cache_bytes()/1024:.0f} KiB resident K/V), "
              f"prefix_cache={'on' if args.prefix_cache else 'off'}")
    prompts = [[2 + (i * 7 + j) % 97 for j in range(5 + i % 3)]
               for i in range(args.requests)]
    reqs = [Request(prompt=p, max_new_tokens=args.max_new,
                    temperature=args.temperature, rid=i)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    t0 = time.time()
    ticks = engine.run_to_completion()
    dt = time.time() - t0
    total = sum(len(r.out_tokens) for r in reqs)
    for r in reqs:
        print(f"req {r.rid}: prompt={r.prompt} -> {r.out_tokens}")
    print(f"{total} tokens in {dt:.2f}s ({total/max(dt,1e-9):.1f} tok/s, "
          f"{ticks} ticks) on {engine.device}")
    print(phase_report(engine, reqs))
    return reqs


if __name__ == "__main__":
    main()
