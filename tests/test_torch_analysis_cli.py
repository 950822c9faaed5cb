"""``python -m repro_torch.analysis.audit`` end to end on the CPU, in a
subprocess: the reference CLI test's matrix (qwen2-0.5b on ``xla`` and
``arrayflex_int8``, unsharded and TP2 over two logical devices), the
reference's cell tags and JSON schema, and only AF008 warnings (the raw
int8 tree quantizes its weights inside the step)."""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_audit_cli_clean_with_tp2(tmp_path):
    out = tmp_path / "audit.json"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.audit", "--device",
         "cpu", "--models", "qwen2-0.5b", "--backends", "xla",
         "arrayflex_int8", "--out", str(out)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    data = json.loads(out.read_text())
    assert set(data) == {"ok", "n_errors", "n_warnings", "meta", "findings"}
    assert data["ok"] and data["n_errors"] == 0
    tags = [c["cell"] for c in data["meta"]["cells"]]
    assert tags == ["qwen2-0.5b/xla/unsharded", "qwen2-0.5b/xla/tp2",
                    "qwen2-0.5b/arrayflex_int8/unsharded",
                    "qwen2-0.5b/arrayflex_int8/tp2"]
    assert data["meta"]["passes"] == ["dispatch", "kernel", "lint"]
    # int8 cells carry the in-step weight quantization warning, by design
    assert data["n_warnings"] > 0
    assert all(f["code"] == "AF008" for f in data["findings"])
    assert {f["where"].split("/")[1] for f in data["findings"]} == \
        {"arrayflex_int8"}
    # each entry's kernel wrapper calls: two shard launches per dispatch at
    # tp 2 on the kernels, none on xla
    for cell in data["meta"]["cells"]:
        for m in cell["entries"].values():
            calls = sum(m["launches"].values())
            want = (0 if "/xla/" in cell["cell"] else m["dispatches"]
                    * (2 if cell["cell"].endswith("tp2") else 1))
            assert calls == want, cell["cell"]
    assert "OK: 0 error(s)" in res.stdout
