"""Arc-flow formulation with graph compression (Brandão & Pedroso [9,10]).

The paper's sidebar builds, per truck (instance) type, a DAG whose nodes are
capacity-usage states and whose arcs place one box (stream). Any source→sink
path is a feasible packing *pattern* for one bin. The multiple-choice variant
keeps one graph per bin type coupled by demand constraints.

We reproduce that construction faithfully for integer-quantized requirement
vectors: items are added type by type (bounded by demand), then the graph is
*compressed* by hash-consing suffix-equivalent nodes (two states whose
remaining-capacity future is identical are merged), which is what makes
hundreds-of-boxes instances tractable in [9].

Downstream use: the exact solver (solver.py) is the branch-and-cut
replacement; this module provides (a) a validated pattern enumerator used in
tests to cross-check the solver on single-choice instances, and (b) per-choice
``max_items_per_bin`` bounds used by heuristics.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator, Sequence


@dataclasses.dataclass(frozen=True)
class IntItem:
    """Quantized item type: integer vector + demand (how many such boxes)."""

    vector: tuple[int, ...]
    demand: int
    label: str = ""


@dataclasses.dataclass
class ArcFlowGraph:
    capacity: tuple[int, ...]
    # arcs: (src_state, dst_state, item_index or -1 for loss arc)
    arcs: list[tuple[tuple[int, ...], tuple[int, ...], int]]
    nodes: set[tuple[int, ...]]
    items: tuple[IntItem, ...]

    @property
    def source(self) -> tuple[int, ...]:
        return tuple(0 for _ in self.capacity)

    @property
    def sink(self) -> tuple[int, ...]:
        return self.capacity


def quantize(vectors: Sequence[Sequence[float]], capacity: Sequence[float],
             levels: int = 200) -> tuple[list[tuple[int, ...]], tuple[int, ...]]:
    """Round item vectors up (conservative) onto an integer grid per dimension."""
    nd = len(capacity)
    cap_int = tuple(levels for _ in range(nd))
    out = []
    for v in vectors:
        q = []
        for d in range(nd):
            if capacity[d] <= 0:
                q.append(0 if v[d] <= 0 else levels + 1)  # cannot fit
            else:
                q.append(int(-(-v[d] * levels // capacity[d])))  # ceil
        out.append(tuple(q))
    return out, cap_int


def build_graph(capacity: tuple[int, ...], items: Sequence[IntItem]) -> ArcFlowGraph:
    """Level-by-level construction: item types in the given order; each type
    expands every current node by up to ``demand`` placements."""
    nd = len(capacity)
    nodes: set[tuple[int, ...]] = {tuple(0 for _ in range(nd))}
    arcs: list[tuple[tuple[int, ...], tuple[int, ...], int]] = []
    seen_arcs: set[tuple[tuple[int, ...], tuple[int, ...], int]] = set()

    for idx, item in enumerate(items):
        frontier = sorted(nodes)
        for node in frontier:
            cur = node
            for _rep in range(item.demand):
                nxt = tuple(c + v for c, v in zip(cur, item.vector))
                if any(x > cap for x, cap in zip(nxt, capacity)):
                    break
                arc = (cur, nxt, idx)
                if arc not in seen_arcs:
                    seen_arcs.add(arc)
                    arcs.append(arc)
                nodes.add(nxt)
                cur = nxt

    # loss arcs: every node can terminate (connect to the sink)
    sink = capacity
    for node in sorted(nodes):
        if node != sink:
            arcs.append((node, sink, -1))
    nodes.add(sink)
    return ArcFlowGraph(capacity=capacity, arcs=arcs, nodes=nodes, items=tuple(items))


def compress(graph: ArcFlowGraph) -> ArcFlowGraph:
    """Merge suffix-equivalent nodes (hash-consing of outgoing structure).

    Two nodes with identical sets of (item, merged-destination) outgoing arcs
    accept exactly the same future packings, so they are interchangeable —
    this is the practical effect of the compression step in [9].
    """
    out_arcs: dict[tuple[int, ...], list[tuple[tuple[int, ...], int]]] = {}
    for src, dst, it in graph.arcs:
        out_arcs.setdefault(src, []).append((dst, it))

    # process nodes in reverse topological order (sum of coords descending)
    order = sorted(graph.nodes, key=lambda n: sum(n), reverse=True)
    canon: dict[tuple[int, ...], tuple[int, ...]] = {}
    sig_to_node: dict[tuple, tuple[int, ...]] = {}
    for node in order:
        outs = frozenset((canon.get(d, d), it) for d, it in out_arcs.get(node, []))
        sig = (outs,)
        if sig in sig_to_node:
            canon[node] = sig_to_node[sig]
        else:
            canon[node] = node
            sig_to_node[sig] = node

    new_arcs: list[tuple[tuple[int, ...], tuple[int, ...], int]] = []
    seen: set = set()
    for src, dst, it in graph.arcs:
        a = (canon.get(src, src), canon.get(dst, dst), it)
        if a[0] == a[1] and it == -1:
            continue
        if a not in seen:
            seen.add(a)
            new_arcs.append(a)
    new_nodes = {canon.get(n, n) for n in graph.nodes}
    return ArcFlowGraph(capacity=graph.capacity, arcs=new_arcs, nodes=new_nodes,
                        items=graph.items)


def patterns(graph: ArcFlowGraph, limit: int = 100_000) -> Iterator[tuple[int, ...]]:
    """Enumerate packing patterns (item-count multisets) as source→sink paths.

    Demand bounds are enforced per path. Patterns are deduplicated.
    """
    out_arcs: dict[tuple[int, ...], list[tuple[tuple[int, ...], int]]] = {}
    for src, dst, it in graph.arcs:
        out_arcs.setdefault(src, []).append((dst, it))
    nitems = len(graph.items)
    emitted: set[tuple[int, ...]] = set()
    budget = [limit]

    def rec(node: tuple[int, ...], counts: list[int]) -> Iterator[tuple[int, ...]]:
        if budget[0] <= 0:
            return
        if node == graph.sink:
            pat = tuple(counts)
            if pat not in emitted:
                emitted.add(pat)
                budget[0] -= 1
                yield pat
            return
        for dst, it in out_arcs.get(node, []):
            if it >= 0:
                if counts[it] >= graph.items[it].demand:
                    continue
                counts[it] += 1
                yield from rec(dst, counts)
                counts[it] -= 1
            else:
                yield from rec(dst, counts)

    yield from rec(graph.source, [0] * nitems)


def max_items_per_bin(graph: ArcFlowGraph) -> int:
    """Longest source→sink path in item-arcs — how many boxes one bin can hold."""
    best = 0
    for pat in patterns(graph):
        best = max(best, sum(pat))
    return best


def min_bins_from_patterns(graph: ArcFlowGraph) -> int:
    """Exact minimum number of identical bins covering all demands, by
    branch-and-bound over the enumerated pattern set (small instances)."""
    pats = [p for p in patterns(graph) if sum(p) > 0]
    if not pats:
        if all(it.demand == 0 for it in graph.items):
            return 0
        raise ValueError("no feasible pattern but demand > 0")
    # prefer patterns that pack more
    pats.sort(key=sum, reverse=True)
    demand = tuple(it.demand for it in graph.items)
    best = [sum(demand)]  # one bin per box is an upper bound IF each fits alone

    def rec(remaining: tuple[int, ...], used: int) -> None:
        if used >= best[0]:
            return
        if all(r <= 0 for r in remaining):
            best[0] = used
            return
        # lower bound: total remaining items / max pattern size
        maxp = sum(pats[0])
        lb = -(-sum(max(r, 0) for r in remaining) // maxp)
        if used + lb >= best[0]:
            return
        tried = set()
        for p in pats:
            # clip pattern to remaining demand to avoid waste-equivalent branches
            eff = tuple(min(c, max(r, 0)) for c, r in zip(p, remaining))
            if sum(eff) == 0 or eff in tried:
                continue
            tried.add(eff)
            rec(tuple(r - c for r, c in zip(remaining, eff)), used + 1)

    rec(demand, 0)
    return best[0]
