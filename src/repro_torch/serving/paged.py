"""Paged K/V state for the serving engine: page pool, radix prefix cache.

Port of the reference's ``serving/paged.py`` (framework-free, a copy).

The dense engine pre-allocates one ``(max_batch, max_seq)`` K/V region and
binds every request to a fixed :class:`~repro_torch.serving.engine.Slot`,
so memory scales with the worst case and concurrency is capped at
``max_batch``.  The paged engine instead owns a global **page pool** per
layer — ``(n_pages, page_size, KV, hd)`` — and gives every admitted
sequence a **block table** mapping its logical cache positions to physical
pages.  Admission tracks *free pages*, not free slots: a short request
reserves ``ceil(target_len / page_size)`` pages, so many short sequences
can be resident at once even though at most ``max_batch`` of them are
bound to dispatch rows per tick (the engine round-robins the rest).

Page 0 is the **scratch page**: never allocated, it backs every
not-yet-reserved block-table entry and every idle dispatch row, so fused
dispatches with partially idle rows have a harmless place to read from.

The **radix prefix cache** (:class:`RadixCache`) is a page-granular trie
over prompt tokens: a node's edge is labelled by ``page_size``-token
chunks, so two prompts sharing a system prefix map their leading block
-table entries to the *same physical pages*.  Sharing is refcounted
copy-on-write at page granularity: only fully-matched pages are shared
(the tree holds one reference, every borrowing sequence one more); at the
divergence point the borrower gets a *fresh* page and recomputes from the
page-aligned boundary, so a shared page is never written after
publication — which keeps paged streams bit-identical to the dense path
(a shared page's K/V is a pure function of (token prefix, positions,
params), independent of who computed it).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.runtime import chaos


class PagePool:
    """Refcounted free-list allocator over the physical K/V pages.

    Page 0 is reserved as the scratch page (see module docstring); the
    allocatable pool is pages ``1..n_pages-1``.  Allocation order is
    deterministic (lowest-numbered free page first) so engine runs are
    reproducible.
    """

    SCRATCH = 0

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError(f"PagePool needs >= 2 pages (one is scratch), "
                             f"got {n_pages}")
        self.n_pages = n_pages
        self.page_size = page_size
        # pop() takes from the end: keep the list descending so the lowest
        # free page id is handed out first.
        self.free_pages = list(range(n_pages - 1, 0, -1))
        self.refcounts = [0] * n_pages

    @property
    def n_free(self) -> int:
        return len(self.free_pages)

    @property
    def n_used(self) -> int:
        return (self.n_pages - 1) - len(self.free_pages)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Reserve ``n`` pages (refcount 1 each), or None if short.

        Chaos injection point ``pool.alloc``: the ambient
        :mod:`repro_torch.runtime.chaos` engine may report exhaustion even
        when pages are free — exercising the caller's head-of-line-retry /
        evict / preempt paths without shrinking the pool (a contextvar
        read when chaos is inactive)."""
        if n > 0 and chaos.fire("pool.alloc",
                                f"n={n} free={len(self.free_pages)}"):
            return None
        if n > len(self.free_pages):
            return None
        pages = [self.free_pages.pop() for _ in range(n)]
        for pg in pages:
            self.refcounts[pg] = 1
        return pages

    def incref(self, page: int):
        if page == self.SCRATCH:
            raise ValueError("scratch page is not refcounted")
        if self.refcounts[page] <= 0:
            raise ValueError(f"incref on free page {page}")
        self.refcounts[page] += 1

    def decref(self, page: int):
        if page == self.SCRATCH:
            raise ValueError("scratch page is not refcounted")
        rc = self.refcounts[page] - 1
        if rc < 0:
            raise ValueError(f"decref on free page {page}")
        self.refcounts[page] = rc
        if rc == 0:
            self.free_pages.append(page)


class _Node:
    """One radix-trie node: a run of page-granular (key, page) pairs."""

    __slots__ = ("keys", "pages", "children", "parent", "last_used")

    def __init__(self, keys=(), pages=(), parent=None):
        self.keys: List[Tuple[int, ...]] = list(keys)
        self.pages: List[int] = list(pages)
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent: Optional["_Node"] = parent
        self.last_used = 0


class RadixCache:
    """Page-granular radix trie mapping token prefixes to physical pages.

    Keys are ``page_size``-token tuples; a node holds a run of consecutive
    pages (path compression), children branch on the next page's key.  The
    tree itself holds one pool reference per published page, so published
    pages survive their producer; :meth:`evict` drops LRU leaves whose
    pages nobody else holds (refcount 1 = tree-only) to refill the pool.
    """

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.root = _Node()
        self._clock = 0
        self.hit_tokens = 0
        self.lookup_tokens = 0

    # ------------------------------------------------------------ helpers
    def _keys(self, tokens) -> List[Tuple[int, ...]]:
        p = self.page_size
        return [tuple(tokens[i * p:(i + 1) * p])
                for i in range(len(tokens) // p)]

    def _split(self, node: _Node, j: int):
        """Split ``node`` after its first ``j`` (key, page) pairs."""
        tail = _Node(node.keys[j:], node.pages[j:], parent=node)
        tail.children = node.children
        for c in tail.children.values():
            c.parent = tail
        tail.last_used = node.last_used
        node.keys = node.keys[:j]
        node.pages = node.pages[:j]
        node.children = {tail.keys[0]: tail}

    def n_nodes(self) -> int:
        out, stack = 0, [self.root]
        while stack:
            nd = stack.pop()
            out += 1
            stack.extend(nd.children.values())
        return out - 1                                  # root not counted

    def n_pages(self) -> int:
        out, stack = 0, [self.root]
        while stack:
            nd = stack.pop()
            out += len(nd.pages)
            stack.extend(nd.children.values())
        return out

    # ------------------------------------------------------------- match
    def match(self, tokens) -> List[int]:
        """Physical pages of the longest fully-paged cached prefix of
        ``tokens``.  Only whole pages match — the caller prefills from the
        page-aligned divergence point (recompute-on-divergence COW)."""
        self._clock += 1
        keys = self._keys(tokens)
        self.lookup_tokens += len(tokens)
        pages: List[int] = []
        node, i = self.root, 0
        while i < len(keys):
            child = node.children.get(keys[i])
            if child is None:
                break
            child.last_used = self._clock
            j = 0
            while (j < len(child.keys) and i < len(keys)
                   and child.keys[j] == keys[i]):
                pages.append(child.pages[j])
                i += 1
                j += 1
            if j < len(child.keys):                     # diverged mid-node
                break
            node = child
        self.hit_tokens += len(pages) * self.page_size
        return pages

    # ------------------------------------------------------------ insert
    def insert(self, tokens, pages: List[int], pool: PagePool) -> int:
        """Publish ``tokens``' full pages into the tree.  ``pages[i]`` is
        the physical page of tokens ``[i*p, (i+1)*p)``.  Pages already
        published (same key path) are left alone; each newly-published
        page gets one tree-owned pool reference.  Returns the number of
        newly published pages."""
        self._clock += 1
        keys = self._keys(tokens)
        node, i = self.root, 0
        while i < len(keys):
            child = node.children.get(keys[i])
            if child is None:
                new = _Node(keys[i:], pages[i:len(keys)], parent=node)
                new.last_used = self._clock
                for pg in new.pages:
                    pool.incref(pg)
                node.children[keys[i]] = new
                return len(new.pages)
            child.last_used = self._clock
            j = 0
            while (j < len(child.keys) and i < len(keys)
                   and child.keys[j] == keys[i]):
                i += 1
                j += 1
            if j < len(child.keys):
                if i == len(keys):                      # prefix of the node
                    return 0
                self._split(child, j)                   # diverged mid-node
            node = child
        return 0

    # --------------------------------------------------------- snapshot
    def to_snapshot(self) -> dict:
        """Pure-python serialization of the trie (engine crash-recovery
        snapshots).  Pool refcounts are snapshotted by the engine; the
        tree carries only its structure and LRU clocks."""
        def ser(node: _Node) -> dict:
            return {"keys": [list(k) for k in node.keys],
                    "pages": list(node.pages),
                    "last_used": node.last_used,
                    "children": [ser(c) for c in node.children.values()]}
        return {"page_size": self.page_size, "clock": self._clock,
                "hit_tokens": self.hit_tokens,
                "lookup_tokens": self.lookup_tokens,
                "root": ser(self.root)}

    @classmethod
    def from_snapshot(cls, snap: dict) -> "RadixCache":
        out = cls(snap["page_size"])
        out._clock = snap["clock"]
        out.hit_tokens = snap["hit_tokens"]
        out.lookup_tokens = snap["lookup_tokens"]

        def de(d: dict, parent: Optional[_Node]) -> _Node:
            node = _Node([tuple(k) for k in d["keys"]], d["pages"],
                         parent=parent)
            node.last_used = d["last_used"]
            for cd in d["children"]:
                child = de(cd, node)
                node.children[child.keys[0]] = child
            return node

        out.root = de(snap["root"], None)
        return out

    # ------------------------------------------------------------- evict
    def evict(self, n_needed: int, pool: PagePool) -> int:
        """Drop least-recently-used leaves whose pages only the tree still
        references (refcount 1), until >= ``n_needed`` pages return to the
        pool or no evictable leaf remains.  Returns pages freed."""
        freed = 0
        while freed < n_needed:
            victim, stack = None, [self.root]
            while stack:
                nd = stack.pop()
                stack.extend(nd.children.values())
                if (nd is not self.root and not nd.children
                        and all(pool.refcounts[pg] == 1 for pg in nd.pages)
                        and (victim is None
                             or nd.last_used < victim.last_used)):
                    victim = nd
            if victim is None:
                break
            for pg in victim.pages:
                pool.decref(pg)
            freed += len(victim.pages)
            del victim.parent.children[victim.keys[0]]
        return freed


class PagedSeq:
    """A resident sequence: request + block table (no fixed slot).

    Unlike :class:`~repro_torch.serving.engine.Slot`, a PagedSeq is created
    per admitted request and holds the request's page reservations; the
    engine binds at most ``max_batch`` of them to dispatch rows each tick.
    """

    PREFILL, DECODE = "prefill", "decode"

    def __init__(self, req, n_table_entries: int, prompt=None):
        self.req = req
        # effective prompt: a preempted request re-admits with its
        # original prompt + already-generated tokens, so recompute (via
        # the prefix cache when warm) reproduces the K/V state exactly
        self.prompt: List[int] = (list(prompt) if prompt is not None
                                  else list(req.prompt))
        self.block_table = [PagePool.SCRATCH] * n_table_entries
        self.n_shared = 0          # leading block_table entries borrowed
        self.published = False     # prefix pages handed to the radix tree
        self.state = PagedSeq.PREFILL
        self.pos = 0
        self.prefill_len = len(self.prompt) - 1
        self.prefill_done = 0
        self.next_token = 0
        self.t_admit = 0.0
        self.admit_idx = 0         # monotonic admission number (preemption
        #                            picks the youngest deterministically)

    def to_decode(self):
        self.state = PagedSeq.DECODE
        self.pos = self.prefill_len
        self.next_token = self.prompt[-1]

    @property
    def write_pos(self) -> int:
        return (self.prefill_done if self.state == PagedSeq.PREFILL
                else self.pos)
