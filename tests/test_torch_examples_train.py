"""The port's other four examples (``examples/torch/``: pipeline_parallel,
serve_lm, train_lm, fault_tolerant_training) against the reference's, on
the CPU; and every port example's imports and default device.

- pipeline_parallel: the planning rows equal ``repro.parallel.pipeline``'s
  and the GPipe output is within 1e-5 of the numpy sequential result.
- serve_lm: the plan lines equal those the reference example prints (its
  ``serve.main`` replaced by a stub: the lines come before it, and the
  reference's streams come from other weights); 6 requests x 16 tokens.
- train_lm: with ``--small --steps 3`` the ``--arrayflex-report`` lines
  equal those the reference example prints (the reference stopped once
  they are out, before its training starts), and the loss decreases.
- fault_tolerant_training: 12 steps with the failure at step 5 take one
  restart and end bit-equal to an uninterrupted 12-step run.
"""
import ast
import contextlib
import importlib.util
import io
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.launch import serve as ref_serve
from repro.launch import train as ref_train
from repro.parallel import pipeline as ref_pipeline
from repro_torch import tree as tree_lib

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "serve_lm", "train_lm", "fault_tolerant_training",
            "pipeline_parallel")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_example(name: str):
    return load(ROOT / "examples" / "torch" / f"{name}.py", f"port_{name}")


def reference_main(name: str, argv, buf: io.StringIO) -> None:
    """Run the reference example ``name`` with ``sys.argv`` = ``argv``,
    its stdout into ``buf``."""
    mod = load(ROOT / "examples" / f"{name}.py", f"reference_{name}")
    saved = sys.argv
    sys.argv = [f"{name}.py", *argv]
    try:
        with contextlib.redirect_stdout(buf):
            mod.main()
    finally:
        sys.argv = saved


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_neither_jax_nor_repro(name):
    tree = ast.parse((ROOT / "examples" / "torch" / f"{name}.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert roots & {"jax", "jaxlib", "repro"} == set(), roots
    assert "repro_torch" in roots


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_defaults_to_the_card(name):
    """Without ``--device cpu`` each example asks for the card, and on a
    machine without one it raises before it does any work."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the example would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_example(name).main([])


def test_pipeline_parallel_rows_and_gpipe():
    out = port_example("pipeline_parallel").run("cpu", log=lambda s: None)
    for row in out["rows"]:
        want = ref_pipeline.plan(ref_pipeline.PipelineCost(
            n_pods=8, microbatches=row["microbatches"], layer_time_ms=2.0,
            overhead_ms=0.5))
        assert {k: row[k] for k in want} == want
    assert [r["microbatches"] for r in out["rows"]] == [4, 16, 64]
    rng = np.random.RandomState(0)
    w = (rng.randn(4, 16, 16) * 0.3).astype(np.float32)
    want = rng.randn(8, 4, 16).astype(np.float32)
    for i in range(4):
        want = np.tanh(want @ w[i])
    assert np.max(np.abs(out["out"] - want)) <= 1e-5
    assert out["err"] <= 1e-5


class _Served:
    def __init__(self):
        self.out_tokens = [0] * 16


def test_serve_lm_plan_lines_and_requests(monkeypatch):
    monkeypatch.setattr(ref_serve, "main",
                        lambda argv: [_Served() for _ in range(6)])
    buf = io.StringIO()
    reference_main("serve_lm", [], buf)
    want = buf.getvalue().splitlines()
    got = port_example("serve_lm").run("cpu", log=lambda s: None)
    assert got["lines"] == want[:len(got["lines"])]
    assert len(got["lines"]) == 3 and want[len(got["lines"])] == \
        "example complete"
    assert len(got["streams"]) == 6
    assert all(len(s) == 16 for s in got["streams"])
    assert got["outcomes"] == ["ok"] * 6


class _Stop(Exception):
    pass


def test_train_lm_report_lines_and_loss(tmp_path, monkeypatch):
    def stop(*args, **kwargs):
        raise _Stop

    monkeypatch.setattr(ref_train, "make_host_mesh", stop)
    monkeypatch.chdir(tmp_path)
    buf = io.StringIO()
    with pytest.raises(_Stop):
        reference_main("train_lm", ["--small", "--steps", "3"], buf)
    want = [l for l in buf.getvalue().splitlines()
            if l.startswith(("ArrayFlex plan", "  "))]
    got = port_example("train_lm").run("cpu", steps=3, small=True,
                                       ckpt_dir=str(tmp_path / "ckpt"),
                                       log=lambda s: None)
    assert got["report"] == want and len(want) == 9
    assert len(got["losses"]) == 3 and got["losses"][-1] < got["losses"][0]
    assert np.isfinite(got["losses"]).all()
    assert (tmp_path / "ckpt").exists()


def test_fault_tolerant_training_restart_is_bit_equal(tmp_path):
    ft = port_example("fault_tolerant_training")
    quiet = dict(log=lambda s: None, ckpt_every=4)
    faulted = ft.run("cpu", steps=12, fail_at=5,
                     ckpt_dir=str(tmp_path / "faulted"), **quiet)
    clean = ft.run("cpu", steps=12, fail_at=None,
                   ckpt_dir=str(tmp_path / "clean"), **quiet)
    assert (faulted["steps"], faulted["restarts"]) == (12, 1)
    assert (clean["steps"], clean["restarts"]) == (12, 0)
    a, b = tree_lib.leaves(faulted["state"]), tree_lib.leaves(clean["state"])
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert faulted["loss"] == clean["loss"] and np.isfinite(clean["loss"])
