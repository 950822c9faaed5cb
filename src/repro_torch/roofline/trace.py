"""Dispatch-mode tracer: FLOPs / HBM bytes / collective bytes / memory of an
eager step, per logical device.

The counterpart of the reference's ``roofline/hlo.py``.  The reference
reads its roofline inputs from the optimized HLO of a compiled step; the
port compiles nothing, so :func:`analyze` runs the step itself (on
``meta`` tensors for a dry run, or on real ones) under a
``TorchDispatchMode`` and counts what it dispatches:

  * flops            — ``mm`` / ``addmm`` / ``bmm`` / ``baddbmm`` / ``mv``
                       / ``dot`` (``matmul`` and ``einsum`` reach the mode
                       as these) and convolution forward and backward;
                       every other op counts 0, as in ``hlo.py``.  A
                       grouped convolution's backward has its own formula
                       (:func:`_conv_backward_flops`): each of its two
                       gradients costs the forward's FLOPs, where torch's
                       stock counter books the weight gradient ``groups``
                       times over.
  * hbm_bytes        — operand + result bytes of every aten op that is not
                       a view (views, ``empty``, ``detach`` and the like
                       are free); a result that aliases an operand (an
                       in-place op) is not counted again.  This is the
                       eager program's own traffic: it fuses nothing XLA
                       would.
  * collective bytes — by kind, with ``hlo.py``'s formulas over a group of
                       n shards: an all-gather moves its result x (n-1)/n,
                       an all-reduce its operand x 2(n-1)/n, a
                       collective-permute its result.  The port's
                       single-controller mesh has no collective ops; the
                       copies that stand for them report themselves
                       (:func:`collective`): the block writes of the
                       substrate's ``_assemble`` (all-gathers), the fp32
                       partial sums of a sharded contraction (the psum),
                       a pipeline stage's hand-off (collective-permute),
                       ``parallel.compression.compressed_allreduce``.
  * memory           — live bytes per logical device: an op's fresh
                       result storage is added where it is born and
                       subtracted when it dies (a ``weakref.finalize`` on
                       the untyped storage, so views and tensors autograd
                       saves count once and as long as they live).

**Kernel launches** are invisible to a dispatch mode (the port loads its
CUDA kernels with ``ctypes``).  Each kernel wrapper is decorated with
:func:`kernel`, which books the wrapper's logical FLOPs (2·M·N·K per
contraction) and its operand and result bytes, and silences every aten op
the wrapper runs inside (the plain version on a CPU tensor, the output
allocation on a CUDA one) — so one step counts the same FLOPs on
``arrayflex`` as on ``xla``, on the CPU and on the card.

**Per device.**  The logical devices of a mesh can share one
``torch.device`` (``launch.mesh``; all are ``meta`` in a dry run), so the
tracer cannot tell shards apart by a tensor's device.  The substrate's
shard loops enter :func:`shard` (the shard's logical device id); every op
outside a shard belongs to the home device 0, where the single controller
gathers.  Backward ops run where their forward ran: an op's autograd node
is tagged with the (device, site) it ran under, and the backward reads
the tag of the node the engine is running.  The ``*_per_device`` keys
hold the busiest logical device (the largest roofline bound); ``devices``
adds the home device's and the mean non-home device's figures.

**Attribution.**  ``top_*`` attribute to the substrate site label
(``attn.wq``, ``mlp.wo``, ...) when an op runs inside a dispatch
(:func:`sited`), else to the aten op's name.

**Listeners.**  The hooks report to the one :class:`Listener` now
active (:func:`listening`): the tracer :func:`analyze` runs, or
``analysis.dispatch_audit``'s routing audit.  Every hook is one read of a
module global when none is active (:func:`kernel` and :func:`sited` add
one call frame).
"""
from __future__ import annotations

import contextlib
import functools
import math
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.roofline import model as roof

aten = torch.ops.aten

HOME = 0                        # the single controller's device
_TAG = "repro_torch.roofline"   # autograd-node metadata key: (device, site)

# the Listener the hooks report to (None: every hook is inert)
_ACTIVE = None

_current_node = getattr(torch._C, "_current_autograd_node", lambda: None)

# ops that move no data: allocations (their storage is still tracked) and
# ``_unsafe_view``, a view its schema does not mark (views proper —
# ``detach`` among them — are told apart by their schema)
_FREE = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                   "new_empty_strided", "lift_fresh", "_unsafe_view"})


def _prod(xs) -> int:
    return math.prod(int(x) for x in xs)


# ---------------------------------------------------------------------------
# FLOP formulas (logical: 2 per multiply-add of a contraction)

def _mm(args):
    a, b = args[0], args[1]
    return 2 * a.shape[0] * a.shape[1] * b.shape[1]


def _addmm(args):
    return _mm(args[1:])


def _bmm(args):
    a, b = args[0], args[1]
    return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


def _baddbmm(args):
    return _bmm(args[1:])


def _mv(args):
    return 2 * args[0].shape[0] * args[0].shape[1]


def _dot(args):
    return 2 * args[0].shape[0]


def _conv_flops(x_shape, w_shape, out_shape, transposed: bool) -> int:
    """2 x (every output element) x (the weights each one reads): a
    weight is (C_out, C_in / groups, *k), so a grouped conv reads
    ``prod(w.shape[1:])`` weights an output element.  A transposed conv
    runs the same products from each input element."""
    per = _prod(w_shape[1:])
    return 2 * per * _prod(x_shape if transposed else out_shape)


def _conv(args, out):
    return _conv_flops(args[0].shape, args[1].shape, out.shape,
                       bool(args[6]))


def _conv_backward_flops(args, out) -> int:
    """``convolution_backward(grad_out, input, weight, ..., transposed,
    output_padding, groups, output_mask)``: the input gradient and the
    weight gradient each run the forward's multiply-adds (each output
    element meets each weight of its window once), grouped or not; the
    bias gradient is a sum (0, as ``hlo.py`` counts reductions)."""
    grad_out, x, w = args[0], args[1], args[2]
    mask = args[10]
    fwd = _conv_flops(x.shape, w.shape, grad_out.shape, bool(args[7]))
    return fwd * (int(bool(mask[0])) + int(bool(mask[1])))


_FLOPS = {
    aten.mm: lambda a, o: _mm(a),
    aten.addmm: lambda a, o: _addmm(a),
    aten.bmm: lambda a, o: _bmm(a),
    aten.baddbmm: lambda a, o: _baddbmm(a),
    aten.mv: lambda a, o: _mv(a),
    aten.dot: lambda a, o: _dot(a),
    aten.vdot: lambda a, o: _dot(a),
    aten.convolution: _conv,
    aten.convolution_backward: _conv_backward_flops,
}

# OpOverload -> (moves no data, flop formula or None, result shares an
# operand's storage: a view or an in-place op)
_KINDS: dict = {}


def _kind(func):
    k = _KINDS.get(func)
    if k is None:
        pkt = func.overloadpacket
        aliased = func.is_view or any(r.alias_info is not None
                                      for r in func._schema.returns)
        free = func.is_view or pkt.__name__ in _FREE
        k = _KINDS[func] = (free, _FLOPS.get(pkt), aliased)
    return k


def _tensors(x, out: list) -> list:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


def nbytes(*trees) -> int:
    """Bytes of the tensors in ``trees`` (tensors, or lists, tuples and
    dicts of them; anything else counts 0)."""
    return sum(t.numel() * t.element_size() for t in _tensors(trees, []))


# ---------------------------------------------------------------------------
# scopes

class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Scope:
    """Inside, ops run on logical device ``dev`` (None: unchanged) under
    site label ``site`` (None: unchanged)."""

    __slots__ = ("tr", "dev", "site", "saved")

    def __init__(self, tr, dev, site):
        self.tr, self.dev, self.site = tr, dev, site

    def __enter__(self):
        tr = self.tr
        tr._flush()
        self.saved = (tr._dev, tr._site)
        if self.dev is not None:
            tr._dev = self.dev
        if self.site is not None:
            tr._site = self.site
        return None

    def __exit__(self, *exc):
        self.tr._flush()
        self.tr._dev, self.tr._site = self.saved
        return False


class Listener:
    """What the hooks report to while it is active (:func:`listening`).
    The defaults change nothing: a listener overrides what it watches."""

    def scope(self, dev, site):
        """A context the ops inside run in: a shard loop's logical device
        ``dev`` (None: unchanged), a dispatch's ``site`` label (None:
        unchanged)."""
        return _NULL

    def kernel(self, name: str, cost, fn, args, kwargs):
        """One call of the kernel wrapper ``name``: runs it."""
        return fn(*args, **kwargs)

    def collective(self, kind: str, t, n: int, t2=None) -> None:
        """One collective of ``kind`` over ``n`` shards (:func:`collective`)."""


@contextlib.contextmanager
def listening(listener: Listener):
    """Make ``listener`` the one the hooks report to (they do not nest)."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError(f"a hook listener is already active: {_ACTIVE!r}")
    _ACTIVE = listener
    try:
        yield listener
    finally:
        _ACTIVE = None


def shard(mesh, coord):
    """The substrate's shard loops: inside, ops run on ``mesh``'s logical
    device at ``coord`` (axis name -> index)."""
    tr = _ACTIVE
    return _NULL if tr is None else tr.scope(mesh.device_id(coord), None)


def sited(fn):
    """Decorator of the substrate's dispatch entries: inside, ops are
    attributed to the call's ``site=`` label."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        tr = _ACTIVE
        if tr is None:
            return fn(*args, **kwargs)
        with tr.scope(None, kwargs.get("site") or None):
            return fn(*args, **kwargs)
    return wrapper


def kernel(cost):
    """Decorator of a kernel wrapper: the tracer books ``cost(*args,
    **kwargs)`` — (logical FLOPs, operand bytes) — plus the result's bytes
    for the call, and silences the aten ops the wrapper runs inside."""
    def deco(fn):
        name = fn.__name__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            tr = _ACTIVE
            if tr is None:
                return fn(*args, **kwargs)
            return tr.kernel(name, cost, fn, args, kwargs)
        return wrapper
    return deco


def collective(kind: str, t, n: int, t2=None) -> None:
    """One collective of ``kind`` over a group of ``n`` shards whose
    per-device buffer is ``t`` (and ``t2``, a second buffer moved with it):
    the gathered result of an all-gather, the operand of an all-reduce,
    the result of a collective-permute (a tensor or a tree of them)."""
    tr = _ACTIVE
    if tr is not None:
        tr.collective(kind, t, n, t2)


# ---------------------------------------------------------------------------
# the tracer

class _Device:
    __slots__ = ("flops", "mem", "coll", "attr_flops", "attr_mem",
                 "attr_coll", "live", "peak", "args", "outs")

    def __init__(self):
        self.flops = 0.0
        self.mem = 0.0
        self.coll = defaultdict(float)
        self.attr_flops = defaultdict(float)
        self.attr_mem = defaultdict(float)
        self.attr_coll = defaultdict(float)
        self.live = 0       # bytes of storages born in the run, alive now
        self.peak = 0
        self.args = 0
        self.outs = 0


class _Tracer(TorchDispatchMode, Listener):
    """The mode :func:`analyze` runs a step under (one per call)."""

    def __init__(self):
        super().__init__()
        self.devs = defaultdict(_Device)
        self._dev = None        # explicit shard scope (None: none)
        self._site = None
        self._quiet = 0         # > 0 inside a kernel wrapper
        self._pending = None    # (weakrefs of the last results, tag)
        self._born = {}         # id(storage) -> (device, bytes, finalizer)
        self._arg_ids = set()
        self._arg_storages = []

    # -- where an op runs --------------------------------------------------
    def _where(self):
        """(device, site) of the op now dispatching: the explicit scope's;
        in a backward formula (grad mode off inside the engine's node) the
        tag of the node; else the home device.  A remat recompute runs
        forward code inside a node with grad mode on: its own scopes
        place it, not the node that asked for it."""
        if self._dev is not None:
            return self._dev, self._site
        if not torch.is_grad_enabled():
            node = _current_node()
            if node is not None:
                tag = node.metadata.get(_TAG)
                if tag is not None:
                    return tag
        return HOME, self._site

    def _flush(self):
        """Tag the autograd nodes of the last op's results with the
        (device, site) the op ran under (autograd attaches a node only
        after the op returns through the mode)."""
        p = self._pending
        if p is None:
            return
        self._pending = None
        refs, tag = p
        for r in refs:
            t = r()
            fn = None if t is None else t.grad_fn
            if fn is not None and _TAG not in fn.metadata:
                fn.metadata[_TAG] = tag

    # -- booking -----------------------------------------------------------
    def _book(self, dev, label, flops, mem):
        d = self.devs[dev]
        if flops:
            d.flops += flops
            d.attr_flops[label] += flops
        if mem:
            d.mem += mem
            d.attr_mem[label] += mem

    def scope(self, dev, site):
        return _Scope(self, dev, site)

    def collective(self, kind, t, n, t2=None):
        """Book the bytes ``hlo.py``'s formulas move (none for one shard)."""
        if n <= 1:
            return
        b = float(nbytes(t, t2))
        if kind == "all-gather":
            moved = b * (n - 1) / n
        elif kind == "all-reduce":
            moved = b * 2.0 * (n - 1) / n
        else:                               # collective-permute
            moved = b
        dev, site = self._where()
        d = self.devs[dev]
        d.coll[kind] += moved
        d.attr_coll[site or kind] += moved

    def _track(self, results, dev):
        for t in results:
            st = t.untyped_storage()
            key = id(st)
            if key in self._born or key in self._arg_ids:
                continue
            n = st.nbytes()
            fin = weakref.finalize(st, self._free, key)
            fin.atexit = False
            self._born[key] = (dev, n, fin)
            d = self.devs[dev]
            d.live += n
            if d.live > d.peak:
                d.peak = d.live

    def _free(self, key):
        ent = self._born.pop(key, None)
        if ent is not None:
            self.devs[ent[0]].live -= ent[1]

    def _note_args(self, tensors):
        for t in tensors:
            st = t.untyped_storage()
            if id(st) in self._arg_ids:
                continue
            self._arg_ids.add(id(st))
            self._arg_storages.append(st)
            self.devs[HOME].args += st.nbytes()

    def kernel(self, name, cost, fn, args, kwargs):
        if self._quiet:
            return fn(*args, **kwargs)
        self._flush()
        self._quiet += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._quiet -= 1
        flops, operand_bytes = cost(*args, **kwargs)
        dev, site = self._where()
        self._book(dev, site or name, float(flops),
                   float(operand_bytes + nbytes(out)))
        self._track([out], dev)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        self._flush()
        free, flop_fn, aliased = _kind(func)
        dev, site = self._where()
        results = None if aliased else _tensors(out, [])
        if results:
            self._track(results, dev)
        if not free:
            mem = nbytes(*_tensors(args, []), *_tensors(kwargs, []))
            if results:
                mem += nbytes(*results)
            flops = flop_fn(args, out) if flop_fn is not None else 0
            self._book(dev, site or func.overloadpacket.__name__,
                       float(flops), float(mem))
        if (dev != HOME or site) and torch.is_grad_enabled():
            refs = [weakref.ref(t) for t in _tensors(out, [])]
            self._pending = (refs, (dev, site))
        return out

    # -- the result ----------------------------------------------------------
    def _finish(self, outputs):
        self._flush()
        seen = set()
        for t in outputs:
            st = t.untyped_storage()
            ent = self._born.get(id(st))
            if ent is not None and id(st) not in seen:
                seen.add(id(st))
                self.devs[ent[0]].outs += ent[1]
        for _, _, fin in list(self._born.values()):
            fin.detach()
        self._born.clear()
        self._arg_storages.clear()

    def result(self, top_k: int = 25, n_devices: int = 0,
               per_device: bool = False) -> dict:
        devs = dict(self.devs) or {HOME: _Device()}

        def bound(d):
            return roof.terms_from_analysis(_per_device(d)).bound_s

        busiest = max(sorted(devs), key=lambda i: bound(devs[i]))
        b = devs[busiest]

        def top(attr):
            return sorted(attr.items(), key=lambda kv: -kv[1])[:top_k]

        res = _per_device(b)
        res.update({
            "unknown_trip_count": False,
            "top_flops": top(b.attr_flops),
            "top_mem": top(b.attr_mem),
            "top_coll": top(b.attr_coll),
            "busiest_device": busiest,
            "memory": _memory(max(devs.values(), key=lambda d: d.peak
                                  + d.args)),
            "totals": {
                "flops": sum(d.flops for d in devs.values()),
                "hbm_bytes": sum(d.mem for d in devs.values()),
                "collective_bytes": sum(sum(d.coll.values())
                                        for d in devs.values()),
            },
        })
        others = [d for i, d in devs.items() if i != HOME]
        n_other = max(n_devices - 1, len(others))
        mean = {k: (sum(_figures(d)[k] for d in others) / n_other
                    if n_other else 0.0)
                for k in _figures(devs.get(HOME, _Device()))}
        res["devices"] = {"n_devices": max(n_devices, len(devs)),
                          "active": len(devs),
                          "home": _figures(devs.get(HOME, _Device())),
                          "non_home_mean": mean}
        if per_device:
            res["per_device"] = {
                i: dict(_figures(d), flops_by_label=dict(d.attr_flops),
                        collective_by_kind=dict(d.coll))
                for i, d in sorted(devs.items())}
        return res


def _per_device(d: _Device) -> dict:
    return {"flops_per_device": d.flops,
            "hbm_bytes_per_device": d.mem,
            "collective_bytes_per_device": dict(d.coll),
            "collective_total_per_device": float(sum(d.coll.values()))}


def _figures(d: _Device) -> dict:
    return {"flops": d.flops, "hbm_bytes": d.mem,
            "collective_bytes": float(sum(d.coll.values())),
            "peak_bytes": float(d.args + d.peak)}


def _memory(d: _Device) -> dict:
    """XLA's memory_analysis fields for one device: ``temp_bytes`` is the
    peak of what was born in the run less the outputs, so argument + temp
    + output is the tracked peak (``peak_bytes``)."""
    temp = max(d.peak - d.outs, 0)
    return {"argument_bytes": d.args, "output_bytes": d.outs,
            "temp_bytes": temp, "alias_bytes": 0,
            "peak_bytes": d.args + max(d.peak, d.outs)}


def analyze(fn, *args, top_k: int = 25, n_devices: int = 0,
            per_device: bool = False) -> dict:
    """Run ``fn(*args)`` under the tracer and return ``hlo.analyze``'s keys
    (``flops_per_device``, ``hbm_bytes_per_device``,
    ``collective_bytes_per_device``, ``collective_total_per_device``,
    ``unknown_trip_count`` — always False: an eager run has no loop to
    multiply — and ``top_flops`` / ``top_mem`` / ``top_coll``) for the
    busiest logical device, plus ``busiest_device``, ``memory`` (the
    argument / output / temp / alias / peak bytes of the device with the
    largest peak), ``totals`` (over every device) and ``devices`` (the
    home device's figures and the mean over the ``n_devices - 1``
    non-home devices; 0: those that ran anything); with ``per_device``
    also each active device's figures, its FLOPs by label and its
    collective bytes by kind (``per_device``).  The inputs are
    counted as the home device's arguments: the single controller holds
    them whole."""
    tr = _Tracer()
    tr._note_args(_tensors(args, []))
    with listening(tr), tr:
        out = fn(*args)
        tr._finish(_tensors(out, []))
    del out
    return tr.result(top_k, n_devices, per_device)
