"""The port's dry run: meta logical devices, ``run_cell`` rows that the
reference's readers (``benchmarks/roofline_table.py``,
``repro.roofline.report``) and the port's report read unchanged, the
sweep's records, and one CLI cell at full size on the production mesh.

The reference's ``repro.launch.dryrun`` is not imported here: it sets
``XLA_FLAGS`` to 512 host devices when imported, which would change the
device count of every later test in the worker.
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from repro.roofline import report as ref_report
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch import dryrun, dryrun_all
from repro_torch.launch import mesh as mesh_lib
from repro_torch.roofline import report

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_meta_logical_devices():
    with mesh_lib.host_devices(512, "meta") as devs:
        assert len(devs) == 512
        assert {d.type for d in devs} == {"meta"}
        mesh = mesh_lib.make_production_mesh()
        assert dict(mesh.shape) == {"data": 16, "model": 16}
        assert mesh.device_id({"data": 2, "model": 3}) == 35
        pods = mesh_lib.make_production_mesh(multi_pod=True)
        assert pods.device_id({"pod": 1}) == 256
        role = mesh_lib.pod_mesh(1, 2, 2, offset=8)
        assert role.device_id({"data": 1, "model": 1}) == 11
    # the serving and training entry points still refuse meta
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def _reduced_cell(monkeypatch):
    """run_cell at a reduced width (B = 16, S = 32) on the production
    mesh: the full machinery at a test's cost."""
    monkeypatch.setattr(dryrun, "model_config_for",
                        lambda arch: reduced(get_config(arch)))
    shapes = {"train_4k": "train", "prefill_32k": "prefill",
              "decode_32k": "decode", "long_500k": "decode"}
    monkeypatch.setattr(dryrun, "get_shape",
                        lambda name: ShapeConfig(name, 32, 16, shapes[name]))


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_rows_read_through_the_reference_readers(shape, tmp_path,
                                                 monkeypatch):
    """A row of run_cell carries every key ``benchmarks/roofline_table.py``
    and the reference's ``roofline/report.py`` read: both, and the port's
    report, turn a results directory of port rows into their rows."""
    _reduced_cell(monkeypatch)
    row = dryrun.run_cell("qwen2-0.5b", shape, False)
    assert row["status"] == "ok"
    assert row["n_devices"] == 256 and row["mesh"] == [16, 16]
    assert row["memory"]["alias_bytes"] == 0
    m = row["memory"]
    assert m["per_device_bytes"] == (m["argument_bytes"] + m["temp_bytes"]
                                     + m["output_bytes"])
    assert m["fits_80g_hbm"] and m["fits_16g_hbm"]
    hl = row["hlo"]
    assert hl["unknown_trip_count"] is False
    assert hl["busiest_device"] == 0
    assert hl["devices"]["n_devices"] == 256
    assert row["cost_analysis"]["flops"] >= hl["flops_per_device"] > 0
    t = row["roofline"]
    assert t["bound_s"] == max(t["compute_s"], t["memory_s"],
                               t["collective_s"])
    assert t["useful_flops_ratio"] == pytest.approx(
        row["model_flops"]["model_flops"] / (hl["flops_per_device"] * 256))
    (tmp_path / f"qwen2-0.5b_{shape}_1pod.json").write_text(json.dumps(row))
    (tmp_path / "qwen2-0.5b_long_500k_1pod.json").write_text(json.dumps(
        dryrun.run_cell("qwen2-0.5b", "long_500k", False)))

    spec = importlib.util.spec_from_file_location(
        "roofline_table", ROOT / "benchmarks" / "roofline_table.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    monkeypatch.setattr(bench, "RESULTS", str(tmp_path))
    rows, derived = bench.roofline_rows()
    assert [(r["arch"], r["shape"]) for r in rows] == [("qwen2-0.5b", shape)]
    assert rows[0]["dominant"] == t["dominant"]
    status, _ = bench.dryrun_status_rows()
    assert {r["status"] for r in status} == {"ok", "skipped"}

    monkeypatch.setattr(ref_report, "RESULTS", str(tmp_path))
    assert f"| qwen2-0.5b | {shape} | 1pod | ok |" in ref_report.dryrun_table()
    assert f"| qwen2-0.5b | {shape} |" in ref_report.roofline_table()
    monkeypatch.setattr(report, "RESULTS", str(tmp_path))
    table = report.dryrun_table()
    assert f"| qwen2-0.5b | {shape} | 1pod | ok |" in table
    assert "| qwen2-0.5b | long_500k | 1pod | SKIP" in table
    assert f"**{t['dominant']}**" in report.roofline_table()


def test_skipped_and_failed_cells_are_data(capsys):
    row = dryrun.run_cell("qwen2-0.5b", "long_500k", False)
    assert row["status"] == "skipped" and "sub-quadratic" in row["reason"]
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "no-such-arch", "--shape", "decode_32k"])
    assert e.value.code == 1
    out = json.loads(capsys.readouterr().out)
    assert out["status"] == "error" and "no-such-arch" in out["error"]


def test_sweep_records_timeouts_and_reuses_results(tmp_path, monkeypatch):
    """dryrun_all writes a timed-out cell as ``timeout`` (its seconds for
    the report) and reruns it; an ``ok`` cell is read back, not rerun."""
    monkeypatch.setattr(dryrun_all, "RESULTS_DIR", str(tmp_path))
    calls = []

    def slow(cmd, **kw):
        calls.append(cmd)
        raise subprocess.TimeoutExpired(cmd, kw["timeout"])

    monkeypatch.setattr(dryrun_all.subprocess, "run", slow)
    r, cached = dryrun_all.run_cell("jamba-1.5-large-398b", "train_4k",
                                    False, timeout=7)
    assert r["status"] == "timeout" and not cached
    assert calls[0][1:3] == ["-m", "repro_torch.launch.dryrun"]
    assert json.loads(Path(dryrun_all.cell_path(
        "jamba-1.5-large-398b", "train_4k", False)).read_text()) == r
    dryrun_all.run_cell("jamba-1.5-large-398b", "train_4k", False)
    assert len(calls) == 2                          # a timeout is retried
    ok = {"arch": "qwen2-0.5b", "shape": "decode_32k", "status": "ok",
          "compile_s": 1.0,
          "memory": {"per_device_gib": 1.0, "fits_80g_hbm": True}}
    Path(dryrun_all.cell_path("qwen2-0.5b", "decode_32k", True)).write_text(
        json.dumps(ok))
    assert dryrun_all.run_cell("qwen2-0.5b", "decode_32k", True) == (ok,
                                                                     True)
    assert len(calls) == 2
    monkeypatch.setattr(report, "RESULTS", str(tmp_path))
    assert "| jamba-1.5-large-398b | train_4k | 1pod | timeout |" \
        in report.dryrun_table()


def test_cli_full_size_cell(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on a full-size cell at the
    single-pod production mesh (whisper-base decode_32k: 256 logical meta
    devices, every GEMM in 256 shards): status ok, its row on disk."""
    out = tmp_path / "cell.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-base", "--shape", "decode_32k", "--out", str(out)],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    seconds = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stderr[-2000:]
    row = json.loads(out.read_text())
    assert row["status"] == "ok" and row["n_devices"] == 256
    assert row["hlo"]["flops_per_device"] > 0
    assert row["hlo"]["collective_bytes_per_device"]["all-gather"] > 0
    assert row["memory"]["per_device_gib"] > 0
    assert seconds < 120
