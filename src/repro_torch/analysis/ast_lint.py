"""AST lint over ``src/repro_torch``: the substrate contract, statically.

Port of the reference's ``analysis/ast_lint.py``.  Three rules:

* **AFL01** — no raw GEMM syntax in the model zones (``nn/``,
  ``models/``, ``serving/``) outside the
  :data:`repro_torch.analysis.contract.ALLOWLIST` — the same allowlist the
  dispatch audit applies to Python frames, so the static and run-time
  views of the rule cannot diverge.  Raw GEMM syntax in torch is ``@``;
  ``matmul``, ``mm``, ``bmm``, ``mv``, ``dot``, ``vdot``, ``inner``,
  ``outer``, ``einsum``, ``tensordot``, ``addmm``, ``baddbmm``,
  ``addbmm``, ``addmv``, ``_int_mm`` and ``_scaled_mm`` as a function or
  a method; ``F.linear`` / ``torch.nn.functional.linear`` (the port's
  own ``layers.linear`` is the dispatching helper, not a raw GEMM); and
  ``conv1d`` / ``conv2d`` / ``conv3d``.
* **AFL02** — every ``substrate.gemm``/``batched_gemm``/``expert_gemm``
  call in the model zones carries a ``site=`` label; literal labels must
  be known to ``planner.site_registry()`` (non-literal labels — e.g. a
  forwarded parameter — are runtime-checked by strict-audit mode
  instead).
* **AFL03** — no mutation of owned mutable state outside its owner
  module(s).  Four ownership groups: the substrate's plan/dispatch state
  (``SITE_PLANS``, ``DISPATCH_COUNTS``, plan/quant caches) belongs to
  ``kernels/substrate.py`` — external code resets through
  ``clear_plan_cache()``/``clear_quant_cache()``, never by poking the
  dicts; the paged-KV page-table/pool state (``free_pages``,
  ``refcounts``, ``block_table``, radix node ``children``) belongs to
  ``serving/engine.py`` + ``serving/paged.py`` — everything else reads
  block tables but may not rewire them, so the refcount/COW invariants
  the prefix cache depends on cannot be broken from a distance; the
  chaos-injection draw state (``chaos_draws``, ``chaos_log``) belongs to
  ``runtime/chaos.py`` — replayability is a pure function of (seed,
  point, draw index) only while the counters advance through
  ``ChaosEngine.fire``; and the engine snapshot ring (``_snapshots``)
  belongs to ``serving/engine.py`` — crash-recovery bit-identity assumes
  a snapshot is immutable once taken.  The substrate group also holds
  the port's weight-block memo (``_SHARD_CACHE``, ``SHARD_CACHE_STATS``:
  reset through ``clear_shard_cache()``).
"""
from __future__ import annotations

import ast
import os
from pathlib import Path
from typing import List, Optional, Sequence

from repro_torch.analysis import contract
from repro_torch.analysis.findings import Finding

# zones where AFL01/AFL02 apply (model code; kernels/ is the substrate)
MODEL_ZONES = ("nn/", "models/", "serving/")

# raw under any name chain (``torch.mm``, ``x.mm``, ``F.conv1d``)
RAW_GEMM_ATTRS = frozenset({
    "matmul", "mm", "bmm", "mv", "dot", "vdot", "inner", "outer", "einsum",
    "tensordot", "addmm", "baddbmm", "addbmm", "addmv", "_int_mm",
    "_scaled_mm", "conv1d", "conv2d", "conv3d",
})
# raw only when the chain ends in the functional module (``F.linear``,
# ``torch.nn.functional.linear``): ``layers.linear`` dispatches
FUNCTIONAL_GEMM_ATTRS = frozenset({"linear"})
FUNCTIONAL_MODULES = frozenset({"F", "functional"})

DISPATCH_FNS = frozenset({"gemm", "batched_gemm", "expert_gemm"})

# substrate-owned mutable state; only kernels/substrate.py may mutate it
TRACKED_STATE = frozenset({
    "SITE_PLANS", "DISPATCH_COUNTS", "PLAN_CACHE_STATS",
    "QUANT_CACHE_STATS", "_QUANT_CACHE", "_plan_gemm_cached",
    "plan_collapse", "attention_plan", "_BACKENDS", "_BACKEND_INFO",
    "_SHARD_CACHE", "SHARD_CACHE_STATS",
})
MUTATORS = frozenset({"clear", "cache_clear", "pop", "popitem", "update",
                      "setdefault", "append", "extend", "insert", "remove",
                      "sort", "reverse"})
STATE_OWNER = os.path.join("kernels", "substrate.py").replace(os.sep, "/")

# paged-KV page-table/pool state; only the serving engine and the paged
# data structures themselves may rewire it (PagePool refcounts, per-seq
# block tables, radix-node children) — a stray append/subscript write
# elsewhere breaks the refcount/COW invariants silently
PAGED_STATE = frozenset({
    "free_pages", "refcounts", "block_table", "children",
})
PAGED_OWNERS = frozenset({
    os.path.join("serving", "engine.py").replace(os.sep, "/"),
    os.path.join("serving", "paged.py").replace(os.sep, "/"),
})

# chaos-injection draw state; only runtime/chaos.py may mutate it.  The
# replay guarantee (decision = f(seed, point, draw index)) dies the moment
# any other module advances a counter or rewrites the fired log
CHAOS_STATE = frozenset({"chaos_draws", "chaos_log"})
CHAOS_OWNER = os.path.join("runtime", "chaos.py").replace(os.sep, "/")

# engine crash-recovery snapshot ring; only serving/engine.py may mutate
# it — restore-time bit-identity assumes snapshots are immutable once taken
SNAPSHOT_STATE = frozenset({"_snapshots"})
SNAPSHOT_OWNER = os.path.join("serving", "engine.py").replace(os.sep, "/")

# ownership groups: (tracked names, owner predicate key, remedy for the msg)
STATE_GROUPS = (
    (TRACKED_STATE, "substrate",
     "substrate plan/dispatch state outside kernels/substrate.py — "
     "use substrate.clear_plan_cache() / clear_shard_cache()"),
    (PAGED_STATE, "paged",
     "paged-KV page-table/pool state outside serving/engine.py + "
     "serving/paged.py — go through PagePool/RadixCache methods"),
    (CHAOS_STATE, "chaos",
     "chaos draw-state outside runtime/chaos.py — fire through "
     "ChaosEngine.fire()/load_state(), never by poking counters"),
    (SNAPSHOT_STATE, "snapshot",
     "engine snapshot state outside serving/engine.py — snapshots are "
     "taken/restored only by the engine itself"),
)


def _name_chain(node) -> List[str]:
    """['substrate', 'DISPATCH_COUNTS', 'clear'] for the attribute chain."""
    chain: List[str] = []
    while isinstance(node, ast.Attribute):
        chain.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        chain.append(node.id)
    return list(reversed(chain))


def _subscript_base(node) -> List[str]:
    return _name_chain(node.value) if isinstance(node, ast.Subscript) else []


class _Linter(ast.NodeVisitor):
    def __init__(self, rel: str):
        self.rel = rel
        self.in_model_zone = rel.startswith(MODEL_ZONES)
        self.owns_state = rel == STATE_OWNER
        self.owned = {"substrate": self.owns_state,
                      "paged": rel in PAGED_OWNERS,
                      "chaos": rel == CHAOS_OWNER,
                      "snapshot": rel == SNAPSHOT_OWNER}
        self.def_stack: List[str] = []
        self.findings: List[Finding] = []

    def _where(self, node) -> str:
        return f"src/repro_torch/{self.rel}:{node.lineno}"

    def _allowlisted(self) -> bool:
        return any(contract.allowlisted(self.rel, fn)
                   for fn in self.def_stack)

    def _emit(self, code: str, node, msg: str) -> None:
        self.findings.append(
            Finding(code, self._where(node), msg, pass_name="lint"))

    # --- scope tracking ---------------------------------------------------
    def visit_FunctionDef(self, node):
        self.def_stack.append(node.name)
        self.generic_visit(node)
        self.def_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    # --- AFL01: raw GEMM syntax ------------------------------------------
    def visit_BinOp(self, node):
        if (self.in_model_zone and isinstance(node.op, ast.MatMult)
                and not self._allowlisted()):
            self._emit("AFL01", node,
                       "raw `@` matmul in a model zone — route through "
                       "kernels.substrate (or add an ALLOWLIST entry with "
                       "justification)")
        self.generic_visit(node)

    # --- calls: AFL01 (raw torch GEMMs), AFL02 (site labels), AFL03 -----
    def visit_Call(self, node):
        chain = _name_chain(node.func)
        if chain:
            raw = chain[-1] in RAW_GEMM_ATTRS or (
                chain[-1] in FUNCTIONAL_GEMM_ATTRS and len(chain) > 1
                and chain[-2] in FUNCTIONAL_MODULES)
            if (self.in_model_zone and raw
                    and not self._allowlisted()):
                self._emit("AFL01", node,
                           f"raw `{'.'.join(chain)}` contraction in a "
                           f"model zone — route through kernels.substrate")
            if self.in_model_zone and chain[-1] in DISPATCH_FNS \
                    and (len(chain) == 1 or chain[-2] == "substrate"):
                self._check_site(node, chain)
            if chain[-1] in MUTATORS:
                for names, owner, remedy in STATE_GROUPS:
                    if (not self.owned[owner]
                            and any(c in names for c in chain[:-1])):
                        self._emit("AFL03", node,
                                   f"`{'.'.join(chain)}()` mutates {remedy}")
                        break
        self.generic_visit(node)

    def _check_site(self, node, chain) -> None:
        site_kw = next((kw for kw in node.keywords if kw.arg == "site"),
                       None)
        if site_kw is None:
            self._emit("AFL02", node,
                       f"substrate.{chain[-1]} dispatch without a site= "
                       f"label — the planner cannot attribute this GEMM")
            return
        val = site_kw.value
        if isinstance(val, ast.Constant) and isinstance(val.value, str):
            from repro_torch.core import planner   # late: import cycle
            known = planner.site_registry()
            bad = [p for p in val.value.split("+") if p not in known]
            if bad:
                self._emit("AFL02", node,
                           f"site={val.value!r} carries label(s) {bad} "
                           f"unknown to planner.model_gemms")

    # --- AFL03: subscript mutation ---------------------------------------
    def _check_subscript_targets(self, node, targets) -> None:
        for tgt in targets:
            chain = _subscript_base(tgt)
            for names, owner, remedy in STATE_GROUPS:
                if (not self.owned[owner]
                        and any(c in names for c in chain)):
                    self._emit("AFL03", node,
                               f"subscript write to `{'.'.join(chain)}` "
                               f"mutates {remedy}")
                    break

    def visit_Assign(self, node):
        self._check_subscript_targets(node, node.targets)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        self._check_subscript_targets(node, [node.target])
        self.generic_visit(node)

    def visit_Delete(self, node):
        self._check_subscript_targets(node, node.targets)
        self.generic_visit(node)


def lint_file(path: Path, rel: str) -> List[Finding]:
    try:
        tree = ast.parse(path.read_text(), filename=str(path))
    except SyntaxError as exc:
        return [Finding("AFL01", f"src/repro_torch/{rel}:{exc.lineno or 0}",
                        f"file does not parse: {exc.msg}",
                        pass_name="lint")]
    linter = _Linter(rel.replace(os.sep, "/"))
    linter.visit(tree)
    return linter.findings


def _default_root() -> Path:
    # src/repro_torch/analysis/ast_lint.py -> src/repro_torch
    return Path(__file__).resolve().parent.parent


def lint_paths(paths: Optional[Sequence] = None,
               root: Optional[Path] = None) -> List[Finding]:
    """Lint ``paths`` (files or directories; default: all of
    src/repro_torch).  ``root`` anchors the zone-relative paths (default:
    the repro_torch package directory)."""
    root = Path(root) if root is not None else _default_root()
    if paths is None:
        paths = [root]
    findings: List[Finding] = []
    for p in paths:
        p = Path(p)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            try:
                rel = str(f.resolve().relative_to(root.resolve()))
            except ValueError:
                rel = f.name
            findings.extend(lint_file(f, rel))
    return findings


def run() -> List[Finding]:
    return lint_paths()
