"""Packed (columnwise) representation of the packing problem — the 10k-stream
fast path.

The object API (:class:`~repro_torch.core.packing.Problem` / ``Item`` / ``Bin``)
is pleasant to reason about but scales as O(streams x choices) Python objects
per control-loop tick: at 10,000 streams over a 35-choice catalog that is
350k requirement tuples *per replan*, and the FFD heuristic's
cost-efficiency opening rule rescans every remaining item per opened bin.

The packed path exploits the fleet's *class structure*: streams are
(program, frame-rate, camera) instances drawn from a small set of
requirement classes G (tens, not thousands), because requirement vectors are
linear in fps and fps comes from a handful of diurnal curves. We therefore:

* build requirement matrices **columnwise** — one ``(G, C, D)`` array of
  per-class requirement vectors (``inf`` where incompatible) instead of N x C
  Python tuples; items of one class *share* a single requirements tuple, so
  the object view stays intact at O(G x C) construction cost;
* run FFD over **runs** of identical items (maximal same-class blocks of the
  size-sorted order) with numpy first-fit masks over all open bins at once,
  falling back to exact per-copy arithmetic inside the chosen bin so
  ``bin_used`` accumulates bit-identically to the scalar path;
* evaluate the bin-opening cost-efficiency rule run-compressed (closed-form
  "how many copies of this class still fit"), and reuse the previous opening
  decision while the only change to the remaining items is the head run's
  count and every choice's head fill is already saturated — which is exactly
  when the decision provably cannot change.

Everything here is semantics-preserving: ``tests/test_packed_parity.py``
asserts bit-identical plans and ledgers against the scalar path, and
``scalar_mode()`` switches the whole pipeline back to the original
per-object code for baselines and property tests.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections.abc import Sequence
from typing import Optional

import numpy as np

from repro_torch.core import geo
from repro_torch.core.packing import EPS, Bin, Infeasible, Item, Problem
from repro_torch.core.workload import (Stream, class_requirement_columns,
                                 requirement_columns)

# ---------------------------------------------------------------------------
# Global switch: the scalar (pre-refactor) path stays available for parity
# tests and the scale_sweep speedup baseline.
# ---------------------------------------------------------------------------

_ENABLED = True


def enabled() -> bool:
    """Whether the vectorized planning/demand path is active."""
    return _ENABLED


@contextlib.contextmanager
def scalar_mode():
    """Run the original per-object / per-stream code paths (parity baseline).

    Inside this context ``build_problem`` builds Items the scalar way (no
    packed arrays attached, so FFD takes its scalar path too) and
    ``DiurnalFleet`` evaluates demand per camera instead of as arrays.
    """
    global _ENABLED
    prev = _ENABLED
    _ENABLED = False
    try:
        yield
    finally:
        _ENABLED = prev


# Cached RTT feasibility: geo.max_fps is a pure function of (camera, region)
# but costs a haversine per call; the scalar path recomputes it per
# (stream, choice) pair.
_MAX_FPS_CACHE: dict[tuple[str, str], float] = {}


def max_fps_cached(camera: str, region: str) -> float:
    key = (camera, region)
    v = _MAX_FPS_CACHE.get(key)
    if v is None:
        v = geo.max_fps(camera, region)
        _MAX_FPS_CACHE[key] = v
    return v


# ---------------------------------------------------------------------------
# Packed problem
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PackedProblem:
    """Columnwise arrays mirroring a :class:`Problem`.

    ``class_req[g, c]`` is class ``g``'s requirement vector under choice
    ``c`` (``+inf`` where incompatible, so a fits-test fails naturally);
    ``item_class[i]`` maps every item to its class. Capacities are the
    usable (90%-capped) vectors, prices are $/hour — identical floats to the
    object view, just laid out for whole-fleet operations.
    """

    item_class: np.ndarray        # (N,) int64
    class_req: np.ndarray         # (G, C, D) float64, +inf = incompatible
    class_compat: np.ndarray      # (G, C) bool
    class_has_compat: np.ndarray  # (G,) bool
    class_size: np.ndarray        # (G,) float64 — FFD norm size (l_inf frac)
    class_kmax: np.ndarray        # (G, C) float64 — copies fitting an empty bin
    capacity: np.ndarray          # (C, D) float64 — usable capacity
    prices: np.ndarray            # (C,) float64 — $/hour
    # requirement *groups*: classes that share (program, fps) — and therefore
    # the same requirement vector on every choice — but may differ in RTT
    # compatibility (different cameras). The opening rule compresses over
    # groups: a greedy fill's accept count for a choice depends only on how
    # many of a group's items are compatible, not on their interleaving.
    class_group: np.ndarray       # (G,) int64 — group id per class
    group_req: np.ndarray         # (G2, C, D) float64, inf = type-incompatible

    @property
    def ndim(self) -> int:
        return self.capacity.shape[1]


def get_packed(problem: Problem) -> Optional[PackedProblem]:
    """The packed arrays attached to a problem, if it was built packed."""
    return getattr(problem, "packed", None)


def _class_arrays(class_reqs: list[tuple], capacity: np.ndarray,
                  prices: np.ndarray) -> tuple:
    """(class_req, compat, has_compat, size, kmax) from per-class req tuples."""
    G, C = len(class_reqs), capacity.shape[0]
    D = capacity.shape[1]
    req = np.full((G, C, D), np.inf)
    for g, per_choice in enumerate(class_reqs):
        for c, r in enumerate(per_choice):
            if r is not None:
                req[g, c] = r
    compat = np.isfinite(req).all(axis=2)
    has_compat = compat.any(axis=1)

    # norm size: max over compatible choices of the max per-dim fraction
    # (same arithmetic as heuristics._norm_size: req/cap, 0-capacity dims
    # contribute 0 when the requirement is 0 too).
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = np.where(capacity[None, :, :] > 0,
                        req / capacity[None, :, :],
                        np.where(req <= 0, 0.0, np.inf))
    frac_max = frac.max(axis=2)                         # (G, C)
    size = np.where(compat, frac_max, -np.inf).max(axis=1)

    # copies of a class fitting an *empty* bin of each choice (0 if
    # incompatible): min over dims of floor((cap + EPS) / req).
    with np.errstate(divide="ignore", invalid="ignore"):
        kd = np.floor((capacity[None, :, :] + EPS) / req)
    kd = np.where(req > 0, kd, np.inf)
    kmax = np.where(compat, kd.min(axis=2), 0.0)
    return req, compat, has_compat, size, kmax


class _PackedItemSeq(Sequence):
    """Lazy ``problem.items``: Item views over (stream id, class) columns.

    At a million streams, materializing N ``Item`` objects per replan is
    the dominant cost of building a problem — and the packed pipeline never
    looks at them (FFD runs on the arrays; reconcile uses ``packed_ids``).
    This sequence constructs an ``Item`` only when some object-path consumer
    actually indexes it; all items of a class share one requirements tuple,
    exactly like the eager builder. ``distinct_requirements()`` hands
    ``Problem.__post_init__`` the per-class tuples so validation stays
    O(classes x choices) without touching any item."""

    __slots__ = ("_ids", "_cls", "_reqs")

    def __init__(self, ids, item_class, class_reqs) -> None:
        self._ids = ids
        self._cls = item_class
        self._reqs = class_reqs

    def __len__(self) -> int:
        return len(self._ids)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[k] for k in range(*i.indices(len(self._ids)))]
        return Item(key=self._ids[i], requirements=self._reqs[self._cls[i]])

    def distinct_requirements(self):
        return self._reqs


def _build_items_from_columns(streams, choices, metas, target_fps,
                              rtt_filter, types, type_ids) -> Problem:
    """Column-native twin of the per-stream class grouping below: factorize
    (program, fps, camera) by integer codes instead of hashing N Python
    tuples. Class/group *numbering* differs from the eager builder (sorted
    by code, not first appearance) — provably irrelevant: the FFD order is a
    stable sort on per-item sizes, runs/blocks/opening decisions depend only
    on class identity patterns and contents, and requirement floats come
    from the same ``requirement_columns`` / ``max_fps_cached`` calls."""
    n = len(streams)
    puniq = streams.programs_unique
    cuniq = streams.cameras_unique
    pcodes = streams.program_codes
    if target_fps is not None:
        fps = np.full(n, float(target_fps))
    else:
        fps = streams.fps
    camk = streams.camera_codes if rtt_filter \
        else np.full(n, -1, dtype=np.int64)

    uf = np.unique(fps)
    fcode = np.searchsorted(uf, fps)
    combo = ((pcodes.astype(np.int64) * (len(cuniq) + 1) + (camk + 1))
             * len(uf) + fcode)
    _, first, item_class = np.unique(combo, return_index=True,
                                     return_inverse=True)
    item_class = item_class.astype(np.int64, copy=False)
    G = len(first)
    cls_p = pcodes[first]
    cls_f = fps[first]
    cls_cam = camk[first]

    gcombo = cls_p.astype(np.int64) * len(uf) + fcode[first]
    _, gfirst, class_group = np.unique(gcombo, return_index=True,
                                       return_inverse=True)
    class_group = class_group.astype(np.int64, copy=False)

    group_per_choice: list[list] = []
    for g2 in gfirst.tolist():
        by_type = class_requirement_columns(puniq[int(cls_p[g2])],
                                            float(cls_f[g2]),
                                            types, target_fps)
        group_per_choice.append(
            [by_type[type_ids[id(t)]] for (t, _loc) in metas])

    class_reqs: list[tuple] = []
    for g in range(G):
        base = group_per_choice[int(class_group[g])]
        ck = int(cls_cam[g])
        if rtt_filter and ck >= 0:
            cam = cuniq[ck]
            f = float(cls_f[g]) if target_fps is None else target_fps
            per_choice = [None if (req is not None
                                   and max_fps_cached(cam, loc) < f)
                          else req
                          for req, (_t, loc) in zip(base, metas)]
            class_reqs.append(tuple(per_choice))
        else:
            class_reqs.append(tuple(base))

    items = _PackedItemSeq(streams.ids, item_class, class_reqs)
    problem = Problem(choices=tuple(choices), items=items)
    _attach_packed(problem, item_class, class_reqs, choices,
                   class_group, group_per_choice)
    object.__setattr__(problem, "packed_ids", streams.ids)
    return problem


def _attach_packed(problem: Problem, item_class, class_reqs, choices,
                   class_group, group_per_choice) -> None:
    capacity = np.array([c.capacity for c in choices], dtype=np.float64)
    prices = np.array([c.price for c in choices], dtype=np.float64)
    req, compat, has_compat, size, kmax = _class_arrays(
        class_reqs, capacity, prices)
    C, D = capacity.shape
    group_req = np.full((len(group_per_choice), C, D), np.inf)
    for g2, per_choice in enumerate(group_per_choice):
        for c, r in enumerate(per_choice):
            if r is not None:
                group_req[g2, c] = r
    packed = PackedProblem(item_class=item_class, class_req=req,
                           class_compat=compat, class_has_compat=has_compat,
                           class_size=size, class_kmax=kmax,
                           capacity=capacity, prices=prices,
                           class_group=np.asarray(class_group,
                                                  dtype=np.int64),
                           group_req=group_req)
    object.__setattr__(problem, "packed", packed)


def build_packed_items(streams, choices, metas, target_fps,
                       rtt_filter) -> Problem:
    """Columnwise item construction: group streams into requirement classes,
    compute each class's vector once per instance *type* (it does not vary by
    location), apply the RTT feasibility column from the cached camera x
    region matrix, and share one requirements tuple across all items of a
    class. Bit-identical to the scalar loop (same ``requirement_for`` and
    ``geo.max_fps`` floats), at O(G x C) instead of O(N x C) cost."""
    # distinct instance types among the (type, location) metas
    type_ids: dict[int, int] = {}
    types = []
    for (t, _loc) in metas:
        if id(t) not in type_ids:
            type_ids[id(t)] = len(types)
            types.append(t)

    if getattr(streams, "program_codes", None) is not None:
        # columnar demand (StreamColumns): factorize by codes, skip the
        # N-item materialization entirely
        return _build_items_from_columns(streams, choices, metas,
                                         target_fps, rtt_filter,
                                         types, type_ids)

    class_of: dict[tuple, int] = {}
    class_rep: list = []                 # representative stream per class
    item_class = np.empty(len(streams), dtype=np.int64)
    for n, s in enumerate(streams):
        fps = target_fps if target_fps is not None else s.fps
        cam = s.camera if (rtt_filter and s.camera is not None) else None
        key = (id(s.program), fps, cam)
        g = class_of.get(key)
        if g is None:
            g = len(class_rep)
            class_of[key] = g
            class_rep.append(s)
        item_class[n] = g

    group_of: dict[tuple, int] = {}
    class_group = np.empty(len(class_rep), dtype=np.int64)
    group_per_choice: list[list] = []
    class_reqs: list[tuple] = []
    for g, s in enumerate(class_rep):
        fps = target_fps if target_fps is not None else s.fps
        gkey = (id(s.program), fps)
        g2 = group_of.get(gkey)
        if g2 is None:
            g2 = len(group_per_choice)
            group_of[gkey] = g2
            by_type = requirement_columns(s, types, target_fps)
            group_per_choice.append(
                [by_type[type_ids[id(t)]] for (t, _loc) in metas])
        class_group[g] = g2
        per_choice = []
        for req, (t, loc) in zip(group_per_choice[g2], metas):
            if req is not None and rtt_filter and s.camera is not None:
                if max_fps_cached(s.camera, loc) < fps:
                    req = None
            per_choice.append(req)
        class_reqs.append(tuple(per_choice))

    items = tuple(Item(key=s.stream_id, requirements=class_reqs[g])
                  for s, g in zip(streams, item_class))
    problem = Problem(choices=tuple(choices), items=items)
    _attach_packed(problem, item_class, class_reqs, choices,
                   class_group, group_per_choice)
    ids = getattr(streams, "ids", None)
    if ids is not None:
        object.__setattr__(problem, "packed_ids", ids)
    return problem


def augment_problem_with_spot(base: Problem,
                              multipliers) -> Problem:
    """The mixed-market problem: ``base`` plus a spot twin of every choice
    whose region has a spot multiplier (same capacity and requirements,
    price = list price x multiplier, ``market="spot"``).

    Item requirement tuples are extended *preserving class sharing*: all
    items that shared one requirements tuple in ``base`` (the packed
    builder's class structure) share one extended tuple here, so
    ``Problem.__post_init__`` still validates O(classes x choices) and the
    repair planner's vectorized overfull pre-screen stays usable. When the
    base problem carries packed arrays, the augmented one gets them too —
    requirement/compat columns tiled onto the spot choices, prices from the
    spot quotes — so ``keep_and_evict`` runs its fast path on mixed plans.
    """
    from repro_torch.core.packing import Choice

    spot_choices: list[Choice] = []
    spot_src: list[int] = []                 # base choice index of each twin
    for c, ch in enumerate(base.choices):
        m = multipliers.get(ch.location)
        if m is None:
            continue
        spot_choices.append(Choice(
            key=ch.key + "!spot", type_name=ch.type_name,
            location=ch.location, capacity=ch.capacity,
            price=ch.price * m, has_gpu=ch.has_gpu, market="spot"))
        spot_src.append(c)
    if not spot_choices:
        return base

    if isinstance(base.items, _PackedItemSeq):
        # lazy items: extend the per-class tuples, never touch the N items
        ext = [r + tuple(r[c] for c in spot_src)
               for r in base.items.distinct_requirements()]
        items = _PackedItemSeq(base.items._ids, base.items._cls, ext)
    else:
        extended: dict[int, tuple] = {}      # id(base tuple) -> shared tuple
        items = []
        for it in base.items:
            reqs = extended.get(id(it.requirements))
            if reqs is None:
                reqs = it.requirements + tuple(
                    it.requirements[c] for c in spot_src)
                extended[id(it.requirements)] = reqs
            items.append(Item(key=it.key, requirements=reqs))
        items = tuple(items)
    problem = Problem(choices=base.choices + tuple(spot_choices),
                      items=items)
    ids = getattr(base, "packed_ids", None)
    if ids is not None:
        object.__setattr__(problem, "packed_ids", ids)

    pp = get_packed(base)
    if pp is not None:
        src = np.asarray(spot_src, dtype=np.int64)
        capacity = np.concatenate([pp.capacity, pp.capacity[src]])
        prices = np.concatenate(
            [pp.prices, np.array([c.price for c in spot_choices])])
        class_req = np.concatenate([pp.class_req, pp.class_req[:, src]],
                                   axis=1)
        compat = np.concatenate([pp.class_compat, pp.class_compat[:, src]],
                                axis=1)
        kmax = np.concatenate([pp.class_kmax, pp.class_kmax[:, src]], axis=1)
        group_req = np.concatenate([pp.group_req, pp.group_req[:, src]],
                                   axis=1)
        aug = PackedProblem(
            item_class=pp.item_class, class_req=class_req,
            class_compat=compat, class_has_compat=compat.any(axis=1),
            class_size=pp.class_size, class_kmax=kmax,
            capacity=capacity, prices=prices,
            class_group=pp.class_group, group_req=group_req)
        object.__setattr__(problem, "packed", aug)
    return problem


# ---------------------------------------------------------------------------
# Packed FFD
# ---------------------------------------------------------------------------


def _open_efficiency(pp: PackedProblem, blocks) -> np.ndarray:
    """Cost-efficiency of opening one bin of every choice, vectorized.

    Exactly the scalar ``_cost_efficiency`` semantics, compressed over
    requirement-group *blocks* of the remaining item order. Within a block
    every item carries the same requirement vector per choice and differs at
    most in RTT compatibility, and a greedy fill skips incompatible items
    without touching state — so the accept count for choice ``c`` is
    ``min(compatible-items-in-block, copies-that-still-fit)`` no matter how
    the block's cameras interleave; once one copy is rejected every later
    identical copy is too, so the closed-form count equals the per-item
    scan. ``blocks`` is a sequence of ``(group_id, n_compat)`` with
    ``n_compat`` a per-choice count vector. Returns price / items-held per
    choice (``inf`` where nothing fits).

    Group-aliveness screen: a block of group ``g2`` changes the fill state
    only if some choice still fits one whole copy of ``g2``
    (``floor(resid/req) >= 1`` on every binding dim). Base-dominated items
    (e.g. pipeline crop stages whose binding dim is an fps-independent
    model-load base) tie in norm size across many (program, fps) groups, so
    the sorted order interleaves them into hundreds of tiny blocks — but
    every choice saturates within the first few, after which each later
    block of a dead group provably contributes ``k = 0``. Those blocks are
    skipped without touching state (aliveness is recomputed with the same
    floor-division arithmetic whenever the state changes, so the skip is
    exact), and the scan stops once no group is alive. Counts — and hence
    efficiencies and the opening argmin — are bit-identical to the full
    scan."""
    C, D = pp.capacity.shape
    used = np.zeros((C, D))
    count = np.zeros(C)
    cap_eps = pp.capacity + EPS
    guniq = sorted({g2 for g2, _ in blocks})
    gpos = {g2: i for i, g2 in enumerate(guniq)}
    greq = pp.group_req[guniq]                      # (Gu, C, D)
    gfin = np.where(np.isfinite(greq), greq, 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        def _alive() -> np.ndarray:
            kd = np.floor((cap_eps - used)[None, :, :] / greq)
            kd = np.where(greq > 0, kd, np.inf)
            return (kd.min(axis=2) >= 1.0).any(axis=1)     # (Gu,)

        alive = _alive()
        any_alive = bool(alive.any())
        for g2, n_compat in blocks:
            if not any_alive:
                break
            gi = gpos[g2]
            if not alive[gi]:
                continue
            req = greq[gi]                          # (C, D)
            kd = np.floor((cap_eps - used) / req)
            kd = np.where(req > 0, kd, np.inf)      # only positive dims bind
            k = np.minimum(kd.min(axis=1), n_compat)
            k = np.maximum(k, 0.0)
            if k.any():
                used += k[:, None] * gfin[gi]
                count += k
                alive = _alive()
                any_alive = bool(alive.any())
    with np.errstate(divide="ignore"):
        eff = np.where(count > 0, pp.prices / np.maximum(count, 1.0), np.inf)
    return eff


def _choose_open(problem: Problem, pp: PackedProblem, g: int,
                 blocks, item_idx: int) -> int:
    """The scalar opening rule on packed arrays: among the class's compatible
    choices, minimize (cost-efficiency over remaining items, price); raise
    the same Infeasible errors the scalar path would."""
    eff = _open_efficiency(pp, blocks)
    cands = np.flatnonzero(pp.class_compat[g])
    if cands.size == 0:
        raise Infeasible(
            f"item {problem.items[item_idx].key} has no compatible choice")
    best = min((int(c) for c in cands),
               key=lambda c: (eff[c], problem.choices[c].price))
    if eff[best] == np.inf:
        raise Infeasible(
            f"item {problem.items[item_idx].key} fits no empty instance")
    return best


def ffd_pack_packed(problem: Problem, pp: PackedProblem, bins: list[Bin],
                    bin_used: list[list[float]], items) -> None:
    """Packed first-fit-decreasing over ``items`` into ``bins`` (mutated in
    place, exactly like the scalar ``ffd_pack_into``).

    Items are sorted by class norm-size (stable, so ties keep input order —
    identical to the scalar stable sort) and processed as runs of equal
    class. Per run, one numpy mask finds every currently-fitting open bin;
    bins are then filled left-to-right with exact per-copy arithmetic (the
    same ``u + r <= cap + EPS`` float comparisons and ``+=`` accumulation
    order as the scalar path, so ``bin_used`` ends bit-identical). When no
    bin fits, the opening rule runs run-compressed, with the previous
    decision reused while it provably cannot change (every choice's head
    fill saturated below the remaining count)."""
    idx = np.fromiter(items, dtype=np.int64)
    if idx.size == 0:
        return
    cls = pp.item_class[idx]
    ok = pp.class_has_compat[cls]
    if not ok.all():
        bad = int(idx[int(np.argmin(ok))])      # first infeasible, input order
        raise Infeasible(
            f"item {problem.items[bad].key} has no compatible choice")

    order = idx[np.argsort(-pp.class_size[cls], kind="stable")]
    ocls = pp.item_class[order]
    cuts = np.flatnonzero(ocls[1:] != ocls[:-1]) + 1
    starts = np.concatenate(([0], cuts))
    ends = np.concatenate((cuts, [order.size]))
    run_class = [int(g) for g in ocls[starts]]
    run_len = [int(v) for v in (ends - starts)]
    n_runs = len(run_class)

    # Block structure for the opening rule: maximal same-group segments of
    # the run sequence (at night, thousands of equal-size single-item runs
    # from different cameras collapse into a handful of blocks).
    run_group = pp.class_group[np.asarray(run_class, dtype=np.int64)]
    compat_f = pp.class_compat.astype(np.float64)
    block_of_run = np.empty(n_runs, dtype=np.int64)
    full_blocks: list[tuple[int, np.ndarray]] = []   # (group, n_compat)
    # per-run suffix compat counts within the run's own block
    suffix_compat = [None] * n_runs
    ri = n_runs - 1
    while ri >= 0:
        g2 = int(run_group[ri])
        acc = np.zeros(pp.capacity.shape[0])
        lo = ri
        while lo >= 0 and int(run_group[lo]) == g2:
            lo -= 1
        for rj in range(ri, lo, -1):
            acc = acc + run_len[rj] * compat_f[run_class[rj]]
            suffix_compat[rj] = acc
            acc = acc.copy()
        full_blocks.append((g2, suffix_compat[lo + 1]))
        for rj in range(lo + 1, ri + 1):
            block_of_run[rj] = len(full_blocks) - 1
        ri = lo
    full_blocks.reverse()
    n_blocks = len(full_blocks)
    block_of_run = (n_blocks - 1) - block_of_run

    def rest_blocks(ri: int, consumed: int) -> list:
        """Blocks of ``order[pos:]``: the current run's block minus what has
        been consumed, then every later block whole."""
        g = run_class[ri]
        head = suffix_compat[ri] - consumed * compat_f[g]
        return [(int(run_group[ri]), head)] + full_blocks[block_of_run[ri] + 1:]

    # growable bin-state arrays (parallel to the `bins` object list)
    nb = len(bins)
    cap_rows = max(64, 1 << int(nb + 16).bit_length())
    D = pp.ndim
    bused = np.zeros((cap_rows, D))
    bcap = np.zeros((cap_rows, D))
    bchoice = np.zeros(cap_rows, dtype=np.int64)
    if nb:
        bused[:nb] = np.asarray(bin_used, dtype=np.float64)
        bchoice[:nb] = [b.choice for b in bins]
        bcap[:nb] = pp.capacity[bchoice[:nb]]

    def grow() -> None:
        nonlocal bused, bcap, bchoice, cap_rows
        cap_rows *= 2
        bused = np.concatenate([bused, np.zeros_like(bused)])
        bcap = np.concatenate([bcap, np.zeros_like(bcap)])
        bchoice = np.concatenate([bchoice, np.zeros_like(bchoice)])

    n_preexisting = len(bins)
    # Per-class first-fit cursors. First-fit scans bins in index order, and
    # a bin only ever *gains* load during a pack — once it fails to fit a
    # class it never fits that class again. Each class therefore keeps an
    # ordered queue of not-yet-rejected candidate bins plus a high-water
    # mark of how far it has scanned; every (class, bin) pair is examined
    # O(1) times. Without this, interleaved equal-size classes fragment the
    # order into near-single-item runs and a fresh every-run scan over all
    # open bins turns the pack quadratic (hours at 10^6 streams). Inner
    # fills run on Python floats — IEEE-identical to the numpy elementwise
    # ops, an order of magnitude faster per 4-vector.
    state: dict[int, list] = {}      # g -> [candidate bins, ptr, scanned]
    kmax_of = pp.class_kmax.max(axis=1)       # head saturation thresholds
    pos = 0                                   # global index into `order`
    for ri in range(n_runs):
        g = run_class[ri]
        n = run_len[ri]
        run_items = order[pos:pos + n].tolist()
        reqs_c = pp.class_req[g]              # (C, D)
        k = 0

        st = state.get(g)
        if st is None:
            st = state[g] = [[], 0, 0]
        cands, ptr, scanned = st
        while k < n:
            if ptr >= len(cands):
                if scanned >= nb:
                    break
                # scan only bins appended since this class last looked
                m = (bused[scanned:nb] + reqs_c[bchoice[scanned:nb]]
                     <= bcap[scanned:nb] + EPS).all(axis=1)
                fresh = (scanned + np.flatnonzero(m)).tolist()
                scanned = nb
                if not fresh:
                    continue                   # next pass breaks
                cands = fresh
                ptr = 0
            b = cands[ptr]
            rt = reqs_c[bchoice[b]].tolist()
            ubt = bused[b].tolist()
            cbt = (bcap[b] + EPS).tolist()
            blist = bins[b].items
            filled = False
            while k < n:
                nt = [u + x for u, x in zip(ubt, rt)]
                if not all(v <= c for v, c in zip(nt, cbt)):
                    break
                blist.append(run_items[k])
                ubt = nt
                filled = True
                k += 1
            if filled:
                bused[b] = ubt
            if k < n:
                ptr += 1                       # saturated/unfitting for g
        st[0], st[1], st[2] = cands, ptr, scanned

        # nothing open fits the rest of the run: open bins by the
        # cost-efficiency rule, reusing the decision while it cannot change
        cached_choice: Optional[int] = None
        thr = float(kmax_of[g])               # head saturation threshold
        while k < n:
            head = n - k
            if cached_choice is not None and head >= thr:
                # the only change since the cached decision is the head
                # run's count, and every choice's head fill still saturates
                # below it — the cost-efficiency argmin cannot have moved
                best = cached_choice
            else:
                best = _choose_open(problem, pp, g, rest_blocks(ri, k),
                                    run_items[k])
                cached_choice = best if head >= thr else None
            if nb == cap_rows:
                grow()
            b = nb
            nb += 1
            bchoice[b] = best
            bcap[b] = pp.capacity[best]
            r = reqs_c[best]
            # the scalar path seeds the new bin with the item's own vector
            bused[b] = r
            bins.append(Bin(choice=best, items=[run_items[k]]))
            bin_used.append([0.0] * D)        # synced below
            k += 1
            rt = r.tolist()
            ubt = bused[b].tolist()
            cbt = (bcap[b] + EPS).tolist()
            blist = bins[b].items
            while k < n:
                nt = [u + x for u, x in zip(ubt, rt)]
                if not all(v <= c for v, c in zip(nt, cbt)):
                    break
                blist.append(run_items[k])
                ubt = nt
                k += 1
            bused[b] = ubt
        pos += n

    # sync the object view: pre-existing lists updated in place (the repair
    # planner keeps references), new bins get their final vectors
    for i in range(nb):
        bin_used[i][:] = [float(v) for v in bused[i]]
