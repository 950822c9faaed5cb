"""Serving CLI of the port: chunked batched prefill + continuous decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --requests 6 --max-new 24 --gemm-backend arrayflex

``--gemm-backend arrayflex_int8`` serves int8 weights (W8) and
``arrayflex_w8a8`` int8 weights and per-tile int8 activations (W8A8).
``--arch qwen3-moe-30b-a3b`` serves the MoE family (token-by-token
prefill), e.g. on the CPU:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch qwen3-moe-30b-a3b --gemm-backend arrayflex_int8

``--arch mamba2-370m`` serves the SSM family and ``--arch
jamba-1.5-large-398b`` the hybrid (mamba layers, one attention layer in
eight, a 16-expert MoE on odd layers), both in token mode on every
backend, e.g. on the CPU:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch mamba2-370m --gemm-backend arrayflex_int8

and full-width mamba2-370m on the card with ``--no-reduced`` (0.74 GB of
bf16 parameters); the full hybrid (398B parameters) fits no single card,
so serve it reduced.  ``--arch mixtral-8x22b`` (MoE with a sliding-window
K/V ring), ``--arch llama-3.2-vision-90b`` (vlm: every fifth layer
cross-attends) and ``--arch whisper-base`` (audio: every decoder layer
cross-attends to the encoder's output) serve in token mode on every
backend, the cross-attention against the zero context ``init_cache``
makes (no request carries image embeddings or audio frames), e.g. on
the CPU:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch whisper-base --gemm-backend arrayflex_w8a8

On the card, ``--no-reduced`` serves whisper-base at full width and
depth (74M parameters) and, with ``--n-layers`` cutting the depth,
mixtral-8x22b (5.0 GB of bf16 parameters a layer: ``--n-layers 8`` on
``arrayflex``, 6 on the int8 backends) and llama-3.2-vision-90b (a
multiple of 5 layers: ``--n-layers 10``); llama3-8b, qwen2.5-14b and
stablelm-12b fit at full depth (16 / 29.5 / 24 GB in bf16).

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

The resilience flags: ``--max-queue`` sheds overload typed
(``rejected_overload``), ``--deadline-ms`` / ``--ttft-deadline-ms``
expire requests typed (``deadline_expired``), ``--preempt-policy
youngest`` reserves pages lazily and preempts instead of failing,
``--chaos`` injects seeded faults (keys seed, gemm, nan, pages, crash and
their ``_at`` variants) and ``--snapshot-every`` / ``--max-restarts``
drive crash recovery (a crash spec forces a snapshot every tick), e.g.
on the CPU, every request ending ``[ok]``:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --gemm-backend arrayflex --requests 4 --max-new 8 --kv-pages 40 \
      --page-size 16 --chaos "seed=1,crash_at=3"

``--prefill-pods P --decode-pods D`` serves through the disaggregated
engine (``serving/disagg.py``): the prefill role prefills into a cache of
its own and hands each request's K/V to the decode role's cache; one
device runs both roles in turn and keeps a clock for each, e.g. on the
CPU:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --gemm-backend arrayflex --prefill-pods 1 --decode-pods 1

It prints a ``disagg:`` line with the pods and the prefill role's chunk,
and, in the report, the mean virtual TTFT (each request's own role time)
and the role makespan against the colocated sum.

The mesh flags: ``--tp T`` / ``--fsdp F`` shard every GEMM dispatch over
an (F, T) ("data", "model") mesh — column-parallel sites split their
output columns, row-parallel ones their contraction, each shard its own
kernel launch at the shard's shapes — and print a ``mesh:`` line;
``--pp P`` with ``--prefill-pods P --decode-pods P`` pipelines each role's
layers over P stages (dense K/V, batched prefill).  ``--host-devices N``
fans the process out to N logical devices laid round-robin over the
physical devices of ``--device``'s type (N x cpu on the CPU, N x cuda:0 on
one card); a mesh that needs more devices than exist raises.  E.g. on
the CPU:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --gemm-backend arrayflex --tp 2 --fsdp 2 --host-devices 4
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --gemm-backend arrayflex --pp 2 --prefill-pods 2 --decode-pods 2 \
      --host-devices 4

On one card the shards and stages run one after another on it: the mesh
shows the sharded launch structure and its results, not a speed-up.

``--strict-audit`` serves under ``substrate.strict_audit_scope``: a GEMM
dispatched under an unknown or empty site label raises ``[AF007]`` before
it launches, and the engine checks every recorded label at the end of the
run.  The streams are those of the same run without it.

Prints per-request outputs with their outcome, plus per-phase timing:
prefill and decode throughput (tokens/s), dispatch counts, and mean
time-to-first-token.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import time

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import substrate
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import lm
from repro_torch.runtime import chaos
from repro_torch.serving import (AdmissionError, DisaggServeConfig,
                                 DisaggServingEngine, EngineCrash, Request,
                                 ServeConfig, ServingEngine)


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
    if isinstance(engine, DisaggServingEngine):
        sc = engine.sc
        vt = [engine.ttft_virtual[r.rid] for r in reqs
              if r.rid in engine.ttft_virtual]
        vt_ms = 1e3 * sum(vt) / max(len(vt), 1)
        makespan = max(st["prefill_time_s"], st["decode_time_s"])
        out += (f"\ndisagg: {sc.prefill_pods} prefill + {sc.decode_pods} "
                f"decode pod(s), pp={engine.pp}; "
                f"mean virtual TTFT {vt_ms:.1f} ms "
                f"(per-role clocks; wall TTFT above pays the colocated "
                f"interleave)\n"
                f"disagg: role makespan {makespan:.3f}s "
                f"(colocated sum "
                f"{st['prefill_time_s'] + st['decode_time_s']:.3f}s), "
                f"K/V handoff {st['kv_transfer_bytes'] / 1024:.0f} KiB"
                + (f" in {st['kv_transfer_pages']} pages"
                   if engine.paged else "")
                + (f", {st['transfer_retries']} transfer retries"
                   if st["transfer_retries"] else "")
                + (f", {st['pod_losses']} pod losses"
                   if st["pod_losses"] else ""))
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
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request total deadline in ms (0 = none); "
                         "expired requests terminate with outcome "
                         "deadline_expired")
    ap.add_argument("--ttft-deadline-ms", type=float, default=0.0,
                    help="per-request time-to-first-token deadline in ms "
                         "(0 = none)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bounded admission queue (0 = unbounded); overflow "
                         "is rejected typed with outcome rejected_overload")
    ap.add_argument("--chaos", default="",
                    help="seeded fault injection spec, e.g. "
                         "'seed=3,gemm=0.05,nan_at=2,crash_at=10' "
                         "(keys: seed, gemm, nan, pages, crash, + _at "
                         "variants)")
    ap.add_argument("--preempt-policy", default="none",
                    choices=("none", "youngest"),
                    help="on page-pool exhaustion mid-decode: 'youngest' "
                         "preempts the youngest resident sequence (release "
                         "pages, re-queue, recompute via the prefix cache) "
                         "instead of failing; also switches paged admission "
                         "to lazy page reservation")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="engine snapshot cadence in ticks for crash "
                         "recovery (0 = off; forced to 1 when --chaos "
                         "configures a crash)")
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="restore-from-snapshot attempts after injected "
                         "engine crashes before giving up")
    ap.add_argument("--prefill-pods", type=int, default=0,
                    help="disaggregated serving: pods in the prefill role; "
                         "either pod flag > 0 serves through "
                         "DisaggServingEngine (one device runs both roles "
                         "in turn, with per-role clocks)")
    ap.add_argument("--decode-pods", type=int, default=0,
                    help="disaggregated serving: pods in the decode role")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline stages over the 'pod' axis within each "
                         "role; requires --prefill-pods == --decode-pods "
                         "== PP and dense K/V")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree (mesh 'model' axis); "
                         "GEMMs plan and launch per shard")
    ap.add_argument("--fsdp", type=int, default=1,
                    help="FSDP/data-parallel degree (mesh 'data' axis)")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="fan the process out to N logical devices over "
                         "the physical devices of --device's type (the "
                         "meshes are built over them)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu (the kernels' "
                         "plain PyTorch versions)")
    ap.add_argument("--strict-audit", action="store_true",
                    help="routing violations (unknown/missing site= labels) "
                         "raise [AF007] RuntimeErrors at dispatch time, and "
                         "run_to_completion cross-checks every recorded "
                         "site against planner.model_gemms")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.prefix_cache and not args.kv_pages:
        ap.error("--prefix-cache requires --kv-pages (paged mode)")
    disagg = args.prefill_pods > 0 or args.decode_pods > 0
    if args.pp > 1 and not disagg:
        ap.error("--pp requires disaggregated serving "
                 "(--prefill-pods/--decode-pods)")
    with (mesh_lib.host_devices(args.host_devices, args.device)
          if args.host_devices else contextlib.nullcontext()), \
         (substrate.strict_audit_scope() if args.strict_audit
          else contextlib.nullcontext()):
        return _serve(args, disagg)


def _serve(args, disagg: bool):

    cfg = get_config(args.arch)
    lm.check_supported(cfg)
    if args.reduced:
        cfg = reduced(cfg)
    substrate.check_backend(args.gemm_backend)
    cfg = dataclasses.replace(
        cfg, gemm_backend=args.gemm_backend,
        param_dtype=cfg.param_dtype if args.reduced else "bfloat16",
        n_layers=args.n_layers or cfg.n_layers)
    if args.tp > 1 or args.fsdp > 1:
        cfg = dataclasses.replace(cfg, mesh_shape=(args.fsdp, args.tp))
        print(f"mesh: data={args.fsdp} x model={args.tp} over "
              f"{len(mesh_lib.devices())} host devices")
    params = lm.init_params(cfg, seed=0, device=args.device)
    chaos_cfg = chaos.parse_spec(args.chaos) if args.chaos else None
    snapshot_every = args.snapshot_every
    if (chaos_cfg is not None and not snapshot_every
            and (chaos_cfg.crash > 0.0 or chaos_cfg.crash_at >= 0)):
        snapshot_every = 1      # crash chaos without snapshots cannot recover
    sc_kwargs = dict(max_batch=args.max_batch, max_seq=128,
                     prefill_mode=args.prefill_mode,
                     prefill_chunk=args.prefill_chunk,
                     kv_pages=args.kv_pages, page_size=args.page_size,
                     prefix_cache=args.prefix_cache,
                     max_queue=args.max_queue, deadline_ms=args.deadline_ms,
                     ttft_deadline_ms=args.ttft_deadline_ms,
                     preempt_policy=args.preempt_policy,
                     snapshot_every_ticks=snapshot_every, chaos=chaos_cfg)
    if disagg:
        engine_cls = DisaggServingEngine
        sc = DisaggServeConfig(prefill_pods=max(1, args.prefill_pods),
                               decode_pods=max(1, args.decode_pods),
                               pp_stages=max(1, args.pp), **sc_kwargs)
    else:
        engine_cls = ServingEngine
        sc = ServeConfig(**sc_kwargs)
    engine = engine_cls(cfg, params, sc, device=args.device)
    if engine_cls is DisaggServingEngine:
        print(f"disagg: {sc.prefill_pods} prefill + {sc.decode_pods} decode "
              f"pod(s), pp={sc.pp_stages}, prefill_chunk="
              f"{engine.prefill_chunk}")
    if chaos_cfg is not None:
        print(f"chaos: {args.chaos} (snapshot every "
              f"{snapshot_every or 'never'} ticks)")
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
        try:
            engine.submit(r)
        except AdmissionError as e:
            print(f"req {r.rid}: rejected ({e})")
    t0 = time.time()
    ticks, restarts = 0, 0
    while True:
        try:
            ticks += engine.run_to_completion()
            break
        except EngineCrash as e:
            restarts += 1
            snap = engine.latest_snapshot()
            if snap is None or restarts > args.max_restarts:
                raise
            print(f"engine crashed ({e}); restoring from snapshot "
                  f"[restart {restarts}/{args.max_restarts}]")
        # the crashed engine's prepared tree and cache leave the device
        # before the restored engine prepares its own
        engine = None
        gc.collect()
        engine = engine_cls.restore(cfg, params, sc, snap,
                                    device=args.device)
    dt = time.time() - t0
    # a restored engine rebuilt its Request objects from the snapshot:
    # merge by rid so reporting reflects the final state of every stream
    final = {r.rid: r for r in reqs}
    for r in engine.restored_requests:
        final[r.rid] = r
    reqs = [final[r.rid] for r in reqs]
    total = sum(len(r.out_tokens) for r in reqs)
    for r in reqs:
        print(f"req {r.rid}: prompt={r.prompt} -> {r.out_tokens} "
              f"[{r.outcome or 'pending'}]")
    print(f"{total} tokens in {dt:.2f}s ({total/max(dt,1e-9):.1f} tok/s, "
          f"{ticks} ticks) on {engine.device}")
    if restarts:
        print(f"recovered from {restarts} injected crash(es)")
    print(phase_report(engine, reqs))
    return reqs


if __name__ == "__main__":
    main()
