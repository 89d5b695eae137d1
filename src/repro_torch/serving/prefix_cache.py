"""Block-granular prefix cache over the paged KV pool.
(port of ``repro/serving/prefix_cache.py``: a copy, pure numpy)

Production traffic concentrates on a handful of system prompts; the
paged engine's block tables make sharing their KV a ref-count away. The
cache is a host-side radix map over *full* token blocks: block ``i`` of
a prompt is keyed by the chained digest ``H(key_{i-1} || tokens_i)``, so
a key commits to the entire block-aligned prefix, and the longest cached
chain for a new prompt is a walk from the root. Only full, immutable
blocks are ever cached — the tail page a request is still appending into
is always private (copy-on-write at admit for a fully-cached prompt), so
``_append_kv_page_quant``'s grow-only scale rescale can never corrupt
another reader.

Why sharing is *exact* for int8 pages: the page is the quantization
tile (per-(page, kv-head) scales — the attention analogue of the paper's
Eq. 22 tile), so a cached page's codes+scale are one immutable value
every reader dequantizes identically. See docs/datapath.md and the
"Prefix cache" section of docs/serving_scheduler.md.

Ownership is counted in pages: ``page_rc[p]`` = number of live block
table rows containing ``p``, plus one while the cache itself holds ``p``.
The cache's host-side bookkeeping here pairs with the device-side
``page_refcounts`` leaf (``init_paged_cache``) kept in lockstep by the
engine's admit/release programs.

Eviction is LRU leaf-first and **all-or-nothing**: nodes are evictable
only with no active readers and no cached children (a child's chain
would break if an ancestor vanished), and an admission either finds its
full shortage among evictable nodes or leaves the cache untouched — a
stalled admission never mutates anything (the scheduler property tests
rely on this).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

_DIGEST_SIZE = 16


def block_digests(prompt, block_size: int) -> list[bytes]:
    """Chained blake2b digests of the prompt's *full* token blocks.

    ``digests[i]`` commits to tokens ``[0, (i+1) * block_size)`` — the
    whole aligned prefix, not just block ``i`` — so equal keys imply
    equal prefixes (up to hash collision) and the radix walk needs no
    token re-comparison. The ragged tail (``len % block_size`` tokens)
    is never hashed: partial blocks are never cached.
    """
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    out: list[bytes] = []
    h = b""
    for i in range(prompt.size // block_size):
        block = prompt[i * block_size:(i + 1) * block_size].tobytes()
        h = hashlib.blake2b(h + block, digest_size=_DIGEST_SIZE).digest()
        out.append(h)
    return out


@dataclass
class _Node:
    """One cached full block: ``page`` is the physical pool page holding
    its KV; ``readers`` counts live requests whose block table includes
    that page via this node (matchers and the inserting request alike);
    ``n_children`` guards interior nodes from eviction; ``tick`` is the
    LRU clock."""

    key: bytes
    parent: bytes | None
    page: int
    readers: int = 0
    n_children: int = 0
    tick: int = 0


class PrefixCache:
    def __init__(self, num_blocks: int, block_size: int):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.nodes: dict[bytes, _Node] = {}
        self._tick = 0
        #: block-granular stats: ``hits / lookups`` is the hit rate the
        #: serving benchmark reports as ``prefix_cache.hit_rate``
        self.lookups = 0
        self.hits = 0

    # ------------------------------------------------------------------
    # Queries (pure — safe to call from a stalled admission)
    # ------------------------------------------------------------------
    @property
    def pages_held(self) -> int:
        return len(self.nodes)

    def match(self, prompt) -> list[_Node]:
        """Longest cached chain of full blocks covering the prompt, as a
        root-first node list. Pure peek: no ticks, readers or stats move
        (commit via :meth:`acquire` once the admission is certain)."""
        matched = []
        for key in block_digests(prompt, self.block_size):
            node = self.nodes.get(key)
            if node is None:
                break
            matched.append(node)
        return matched

    def plan_evict(self, shortage: int, protect: set[bytes]):
        """Pick ``shortage`` LRU evictable nodes (readers == 0, no cached
        children, not in ``protect``), cascading leaf-first so a cold
        subtree can be cleared within one plan. Returns the node list, or
        ``None`` when the shortage cannot be fully covered (all-or-
        nothing: the caller must then stall without evicting)."""
        if shortage <= 0:
            return []
        plan: list[_Node] = []
        gone: set[bytes] = set()
        n_children = {}  # simulated child counts under the plan
        while len(plan) < shortage:
            best = None
            for node in self.nodes.values():
                if node.key in gone or node.key in protect or node.readers:
                    continue
                if n_children.get(node.key, node.n_children):
                    continue
                if best is None or node.tick < best.tick:
                    best = node
            if best is None:
                return None
            plan.append(best)
            gone.add(best.key)
            if best.parent is not None:
                parent = self.nodes[best.parent]
                n_children[parent.key] = (
                    n_children.get(parent.key, parent.n_children) - 1)
        return plan

    # ------------------------------------------------------------------
    # Mutations (commit side of an admission / release)
    # ------------------------------------------------------------------
    def acquire(self, matched: list[_Node], n_lookup_blocks: int) -> None:
        """Commit a match: bump readers + LRU ticks and record stats
        (``n_lookup_blocks`` = the prompt's full-block count)."""
        self._tick += 1
        for node in matched:
            node.readers += 1
            node.tick = self._tick
        self.lookups += n_lookup_blocks
        self.hits += len(matched)

    def touch(self, node: _Node) -> None:
        """LRU bump without a reader (the full-hit tail node: its page is
        copied at admit, not referenced afterwards)."""
        self._tick += 1
        node.tick = self._tick

    def insert(self, prompt, row: np.ndarray, start_block: int,
               skip_existing: bool = False) -> list[_Node]:
        """Register the prompt's full blocks ``start_block ..`` (freshly
        prefilled into physical pages ``row[start_block + i]``) as cached,
        with the inserting request as first reader. Returns the new nodes
        (the caller releases their readers at finish).

        ``skip_existing`` tolerates blocks another request cached between
        planning and insertion (the chunked-prefill deferred insert: the
        inserter matched nothing at admit because its own blocks were not
        yet written, but an identical concurrent prompt may have won the
        race) — existing nodes are left untouched, the inserter's row
        simply keeps its private duplicate pages for those blocks."""
        digests = block_digests(prompt, self.block_size)
        self._tick += 1
        created = []
        for i in range(start_block, len(digests)):
            key = digests[i]
            if key in self.nodes:
                assert skip_existing, "insert over an existing node"
                continue
            parent = digests[i - 1] if i else None
            if parent is not None:
                # the parent is always resident: either matched/skipped
                # (in the map already) or created earlier in this loop
                self.nodes[parent].n_children += 1
            node = _Node(key=key, parent=parent, page=int(row[i]),
                         readers=1, tick=self._tick)
            self.nodes[key] = node
            created.append(node)
        return created

    def release(self, nodes: list[_Node]) -> None:
        for node in nodes:
            node.readers -= 1
            assert node.readers >= 0

    def evict(self, plan: list[_Node]) -> None:
        """Drop a :meth:`plan_evict` plan from the map (page pushes happen
        in the scheduler/engine, which own the refcounts)."""
        for node in plan:
            assert node.readers == 0 and node.key in self.nodes
            del self.nodes[node.key]
            if node.parent is not None and node.parent in self.nodes:
                self.nodes[node.parent].n_children -= 1

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        return {
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_rate": self.hits / self.lookups if self.lookups else 0.0,
            "pages_held": self.pages_held,
        }
