"""The substrate contract: which code may legally emit contractions.

Port of the reference's ``analysis/contract.py``, on the port's paths.
Shared by the dispatch audit (Python-frame attribution of each aten op)
and the AST lint (static call-site attribution), so one allowlist governs
both views of the same rule: every model GEMM routes through
``kernels.substrate``.
"""
from __future__ import annotations

import os
from typing import Iterable, Optional, Tuple

# Files whose contractions ARE the substrate: an aten contraction whose
# Python frames pass through any of these is substrate-dispatched by
# construction (the dispatch layer itself, the kernel wrappers and their
# plain versions, and the helpers they stage through).
SUBSTRATE_FILES = (
    os.path.join("kernels", "substrate.py"),
    os.path.join("kernels", "arrayflex_gemm.py"),
    os.path.join("kernels", "ops.py"),
    os.path.join("kernels", "flash_attention.py"),
    os.path.join("kernels", "ref.py"),
)

# (file suffix under src/repro_torch, top-level function) -> justification.
# Contractions reached through these functions are genuinely out of the
# substrate's scope; every entry carries its reason.  The AST lint applies
# the same entries to raw-GEMM syntax in the same functions.  The first
# five are the reference's, reasons included; ``_einsum`` is the port's
# own.
ALLOWLIST = {
    (os.path.join("nn", "mamba.py"), "ssd_chunked"):
        "SSD intra-chunk contractions live inside the inter-chunk state "
        "scan body (rematted, chunk-local shapes); they are part of the "
        "selective-scan recurrence, not a planned model GEMM — pricing "
        "them through Eq.(6') is the ROADMAP SSM-kernel follow-up.",
    (os.path.join("nn", "mamba.py"), "mamba_decode_step"):
        "single-token SSM state update: per-head (N,P)-shaped outer "
        "products and the depthwise-conv window einsum — state recurrence "
        "arithmetic, below the substrate's GEMM granularity.",
    (os.path.join("nn", "mamba.py"), "_causal_conv"):
        "depthwise causal conv (feature_group_count == channels): one "
        "MAC per tap per channel, not a dense contraction the systolic "
        "array would tile.",
    (os.path.join("nn", "attention.py"), "chunked_attention"):
        "flash-style online-softmax KV scan: its QK/PV blocks run inside "
        "the remat'd scan step whose schedule IS the ArrayFlex-collapse "
        "analogue (planner.attention_plan picks the chunk), so the "
        "substrate plan would double-count it.",
    (os.path.join("nn", "moe.py"), "moe_apply_reference"):
        "O(T*E*d*ff) dense oracle used only by equivalence tests — it "
        "deliberately bypasses dispatch to validate the dispatch path.",
    (os.path.join("nn", "moe.py"), "_einsum"):
        "dtype-promoting einsum helper (jnp.einsum's promotion) that only "
        "the dense oracle moe_apply_reference calls; the reference writes "
        "the same einsums inline in that function.",
}


def _norm(path: str) -> str:
    return path.replace(os.sep, "/")


def repro_rel(file_name: str) -> Optional[str]:
    """Path relative to src/repro_torch when ``file_name`` is inside it."""
    marker = _norm(os.path.join("src", "repro_torch")) + "/"
    p = _norm(file_name)
    if marker in p:
        return p.rsplit(marker, 1)[1]
    return None


def is_substrate_file(rel: str) -> bool:
    return any(rel == _norm(s) for s in SUBSTRATE_FILES)


def allowlisted(rel: str, function: str) -> bool:
    return (rel.replace("/", os.sep), function) in ALLOWLIST


def classify_frames(frames: Iterable[Tuple[str, str]]) -> Tuple[str, str]:
    """Attribute an op by its (file, function) Python frames, innermost
    first.  Returns (verdict, where):

    * ``("substrate", rel)``   — reached through the dispatch/kernels;
    * ``("allowlisted", rel#fn)`` — an ALLOWLIST entry is on the stack;
    * ``("unattributed", rel-or-"?")`` — no substrate frame, no allowlist
      entry: a bypass contraction (AF001).
    """
    first_rel = None
    for file_name, function in frames:
        rel = repro_rel(file_name)
        if rel is None:
            continue
        if first_rel is None:
            first_rel = f"{rel}:{function}"
        if is_substrate_file(rel):
            return "substrate", rel
        if allowlisted(rel, function):
            return "allowlisted", f"{rel}#{function}"
    return "unattributed", first_rel or "?"
