"""Dry run of one (arch x shape x mesh) cell: per-device FLOPs, bytes,
collectives and memory, priced on the H100 roofline.

Port of the reference's ``launch/dryrun.py``.  The reference lowers and
compiles each cell's step on 512 host devices and reads the counts from
its HLO; the port compiles nothing.  It builds the step with its inputs
as ``meta`` tensors (``models.api``'s abstract trees: shapes and dtypes,
no storage), lays the production mesh over 512 logical ``meta`` devices
(``launch.mesh.host_devices(512, "meta")``) and runs the step eagerly
under ``roofline.trace``, which counts what it dispatches per logical
device.  No card is needed, and nothing is computed.

The mesh shards what the port's single controller shards: every
substrate GEMM dispatch (``cfg.mesh_shape`` = the production mesh).
Every other op runs whole on the home device, which gathers each GEMM's
blocks, so the busiest device holds full activations and caches.  A
multi-pod mesh's "pod" axis shards nothing (the dispatch splits over
"data" and "model" only).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
      --shape decode_32k [--multi-pod] [--out F.json] [--save-trace T.json]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

from repro_torch.configs import cell_is_runnable, get_config, get_shape
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import api
from repro_torch.optim import OptConfig
from repro_torch.parallel import sharding
from repro_torch.roofline import model as roof
from repro_torch.roofline import trace

# the reference's --xla_force_host_platform_device_count
N_HOST_DEVICES = 512


def opt_config_for(cfg) -> OptConfig:
    # >=50B params: bf16 moments + bf16 stored params with fp32 master
    # (DESIGN.md §Memory budget)
    big = cfg.param_count() > 5e10
    return OptConfig(moment_dtype="bfloat16" if big else "float32",
                     master_weights=big)


def model_config_for(arch: str):
    cfg = get_config(arch)
    if cfg.param_count() > 5e10:
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    # perf-iteration knobs (EXPERIMENTS.md §Perf): override via env
    if os.environ.get("REPRO_REMAT"):
        cfg = dataclasses.replace(cfg, remat=os.environ["REPRO_REMAT"])
    if os.environ.get("REPRO_KV_CHUNK"):
        cfg = dataclasses.replace(
            cfg, attn_kv_chunk=int(os.environ["REPRO_KV_CHUNK"]))
    return cfg


# Gradient-accumulation depth per arch for the train_4k cell: chosen so the
# activation working set fits 16GB v5e HBM (EXPERIMENTS.md §Dry-run).
MICROBATCHES = {
    "jamba-1.5-large-398b": 16,
    "llama-3.2-vision-90b": 8,
    "mixtral-8x22b": 8,
    "qwen3-moe-30b-a3b": 4,
    "qwen2.5-14b": 2,
    "stablelm-12b": 2,
    "llama3-8b": 2,
}


def build_step(cfg, shape, mesh):
    """Returns (fn, args, specs): the step, its ``meta`` inputs and their
    spec trees (``models.api``'s ``*_pspecs`` for ``mesh``).  The port's
    steps write none of their inputs, so nothing is donated."""
    if shape.kind == "train":
        opt_cfg = opt_config_for(cfg)
        fn = api.make_train_step(cfg, opt_cfg,
                                 MICROBATCHES.get(cfg.name, 1))
        args = (api.abstract_params(cfg),
                api.abstract_opt_state(cfg, opt_cfg),
                api.batch_specs(cfg, shape))
        specs = (api.param_pspecs(cfg, mesh),
                 api.opt_pspecs(cfg, opt_cfg, mesh),
                 api.batch_pspecs(cfg, shape, mesh))
        return fn, args, specs
    if shape.kind == "prefill":
        fn = api.make_prefill_step(cfg)
        args = (api.abstract_params(cfg),
                api.batch_specs(cfg, shape, with_labels=False))
        specs = (api.param_pspecs(cfg, mesh),
                 api.batch_pspecs(cfg, shape, mesh, with_labels=False))
        return fn, args, specs
    # decode
    fn = api.make_serve_step(cfg)
    cache, tok, pos = api.decode_specs(cfg, shape)
    cache_ps, tok_ps, pos_ps = api.decode_pspecs(cfg, shape, mesh)
    return (fn, (api.abstract_params(cfg), cache, tok, pos),
            (api.param_pspecs(cfg, mesh), cache_ps, tok_ps, pos_ps))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             save_trace: str = "") -> dict:
    """One cell's row, in the reference's keys.  ``lower_s`` holds the
    seconds of building the step and its meta inputs, ``compile_s`` those
    of the counted meta run (the port compiles nothing).  ``memory`` is
    the tracer's (the device with the largest peak: the home device),
    ``alias_bytes`` 0 (no input is donated); ``fits_16g_hbm`` is kept so
    rows compare with the reference's, ``fits_80g_hbm`` is the H100's
    verdict.  ``save_trace`` writes each logical device's figures there
    (FLOPs by site label, collective bytes by kind)."""
    cfg = model_config_for(arch)
    shape = get_shape(shape_name)
    ok, why = cell_is_runnable(arch, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": why}
    with mesh_lib.host_devices(N_HOST_DEVICES, "meta"):
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
        n_dev = mesh.size
        cfg = dataclasses.replace(cfg, mesh_shape=tuple(mesh.devices.shape))
        t0 = time.time()
        fn, args, _ = build_step(cfg, shape, mesh)
        act_rules = sharding.activation_rules(mesh, shape.global_batch, cfg,
                                              kind=shape.kind)
        t_lower = time.time() - t0
        t0 = time.time()
        with sharding.use_activation_rules(act_rules):
            hl = trace.analyze(fn, *args, n_devices=n_dev,
                               per_device=bool(save_trace))
        t_compile = time.time() - t0
    del fn, args
    if save_trace:
        with open(save_trace, "w") as f:
            json.dump(hl.pop("per_device"), f, indent=1)
    mem = hl.pop("memory")
    totals = hl.pop("totals")
    mf = roof.model_flops(cfg, shape)
    terms = roof.terms_from_analysis(hl)
    per_dev_bytes = (mem["argument_bytes"] + mem["temp_bytes"]
                     + mem["output_bytes"] - mem["alias_bytes"])
    return {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "status": "ok", "n_devices": n_dev,
        "mesh": list(mesh.shape.values()), "axis_names": list(mesh.axis_names),
        "lower_s": round(t_lower, 2), "compile_s": round(t_compile, 2),
        "memory": {
            "argument_bytes": mem["argument_bytes"],
            "output_bytes": mem["output_bytes"],
            "temp_bytes": mem["temp_bytes"],
            "alias_bytes": mem["alias_bytes"],
            "per_device_bytes": per_dev_bytes,
            "per_device_gib": round(per_dev_bytes / 2**30, 3),
            "fits_16g_hbm": bool(per_dev_bytes < 16 * 2**30),
            "fits_80g_hbm": bool(per_dev_bytes < roof.HBM_BYTES),
        },
        "cost_analysis": {"flops": totals["flops"],
                          "bytes_accessed": totals["hbm_bytes"]},
        "hlo": hl,
        "model_flops": mf,
        "roofline": {
            "compute_s": terms.compute_s, "memory_s": terms.memory_s,
            "collective_s": terms.collective_s, "dominant": terms.dominant,
            "bound_s": terms.bound_s,
            "roofline_fraction": terms.roofline_fraction,
            "useful_flops_ratio": (
                mf["model_flops"] /
                max(hl["flops_per_device"] * n_dev, 1.0)),
            "useful_flops_ratio_with_attn": (
                mf["model_flops_with_attn"] /
                max(hl["flops_per_device"] * n_dev, 1.0)),
        },
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="")
    ap.add_argument("--save-trace", default="")
    args = ap.parse_args(argv)
    try:
        res = run_cell(args.arch, args.shape, args.multi_pod,
                       args.save_trace)
    except Exception as e:  # noqa: BLE001 — report failures as data
        res = {"arch": args.arch, "shape": args.shape,
               "multi_pod": args.multi_pod, "status": "error",
               "error": repr(e), "traceback": traceback.format_exc()}
    js = json.dumps(res, indent=1)
    print(js)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(js)
    if res["status"] == "error":
        raise SystemExit(1)


if __name__ == "__main__":
    main()
