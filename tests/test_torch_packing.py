"""The port's packing layer (``repro_torch.core``: packing, heuristics,
solver, arcflow, packed, strategies.build_problem) against the reference's
(``repro.core``) on seeded inputs.

Each side builds its own problem from the same numbers (a seeded numpy
generator drawn once per side). Tolerance: exact. Bins are held item for
item and costs bit for bit (``float.hex``).
"""
import numpy as np
import pytest

import repro.core as R
import repro_torch.core as P
from repro.core import arcflow as ref_arcflow
from repro.core import geo as ref_geo
from repro.core import heuristics as ref_heur
from repro.core import packed as ref_packed
from repro.core import packing as ref_packing
from repro.core import solver as ref_solver
from repro.core import strategies as ref_strategies
from repro_torch.core import arcflow, geo, heuristics, packed, packing, solver
from repro_torch.core import strategies

SIDES = {"ref": (ref_packing, ref_heur, ref_solver),
         "port": (packing, heuristics, solver)}
HEURISTICS = ("first_fit_decreasing", "lowest_price_first",
              "cheapest_instance_first")


def _random_problem(pk, seed, max_items=6, max_choices=3, ndim=2):
    """The reference's solver-test generator, on the packing module ``pk``."""
    rng = np.random.default_rng(seed)
    n_choices = int(rng.integers(1, max_choices + 1))
    choices = []
    for c in range(n_choices):
        cap = tuple(float(rng.uniform(1.0, 10.0)) for _ in range(ndim))
        choices.append(pk.Choice(key=f"c{c}", type_name=f"t{c}", location="x",
                                 capacity=cap,
                                 price=round(float(rng.uniform(0.1, 5.0)), 3)))
    items = []
    for i in range(int(rng.integers(1, max_items + 1))):
        reqs = []
        for c in range(n_choices):
            if rng.random() < 0.5:
                req = tuple(round(float(rng.uniform(0.0, 6.0)), 3)
                            for _ in range(ndim))
                fits_empty = all(r <= k for r, k in
                                 zip(req, choices[c].capacity))
                reqs.append(req if fits_empty else None)
            else:
                reqs.append(None)
        items.append(pk.Item(key=f"i{i}", requirements=tuple(reqs)))
    return pk.Problem(choices=tuple(choices), items=tuple(items))


def _bins(sol):
    return [(b.choice, list(b.items)) for b in sol.bins]


def _outcome(fn, problem, infeasible):
    """(bins, cost hex, optimal, note) of ``fn(problem)``, or "infeasible"."""
    try:
        out = fn(problem)
    except infeasible:
        return "infeasible"
    sol = out[0] if isinstance(out, tuple) else out
    return (_bins(sol), sol.cost.hex(), sol.optimal, sol.note)


@pytest.mark.parametrize("seed", range(12))
def test_solve_and_brute_force_match_reference(seed):
    ref_pb = _random_problem(ref_packing, seed)
    pb = _random_problem(packing, seed)
    assert _outcome(solver.solve, pb, packing.Infeasible) == \
        _outcome(ref_solver.solve, ref_pb, ref_packing.Infeasible)
    assert _outcome(solver.brute_force, pb, packing.Infeasible) == \
        _outcome(ref_solver.brute_force, ref_pb, ref_packing.Infeasible)
    if all(it.compatible() for it in pb.items):
        sol, stats = solver.solve(pb)
        ref_stats = ref_solver.solve(ref_pb)[1]
        assert (stats.nodes, stats.pruned_bound, stats.pruned_memo,
                stats.optimal) == (ref_stats.nodes, ref_stats.pruned_bound,
                                   ref_stats.pruned_memo, ref_stats.optimal)
        assert stats.optimal                 # both sides proved it
        assert sol.cost == pytest.approx(solver.brute_force(pb).cost,
                                         abs=1e-6)
        packing.validate(pb, sol)


def test_brute_force_refuses_large_inputs():
    pb = _random_problem(packing, 0, max_items=12)
    pb = packing.Problem(choices=pb.choices,
                         items=pb.items + pb.items[:8])
    with pytest.raises(ValueError):
        solver.brute_force(pb)


@pytest.mark.parametrize("name", HEURISTICS)
def test_heuristics_match_reference(name):
    for seed in range(40):
        ref_pb = _random_problem(ref_packing, seed, max_items=10,
                                 max_choices=4, ndim=3)
        pb = _random_problem(packing, seed, max_items=10, max_choices=4,
                             ndim=3)
        got = _outcome(getattr(heuristics, name), pb, packing.Infeasible)
        assert got == _outcome(getattr(ref_heur, name), ref_pb,
                               ref_packing.Infeasible)
        if got != "infeasible":
            packing.validate(pb, getattr(heuristics, name)(pb))


def test_ffd_pack_into_seeded_bins_matches_reference():
    """The repair planner's delta pass: first-fit the second half of the
    items into the bins an FFD of the first half opened."""
    n_checked = 0
    for seed in range(40):
        per_side = []
        for pk, heur, _ in SIDES.values():
            pb = _random_problem(pk, seed, max_items=10, max_choices=4,
                                 ndim=3)
            pb = pk.Problem(choices=pb.choices, items=tuple(
                it for it in pb.items if it.compatible()))
            if not pb.items:
                per_side.append(None)
                continue
            half = len(pb.items) // 2
            first = pk.Problem(choices=pb.choices, items=pb.items[:half]) \
                if half else None
            bins = [] if first is None else \
                [pk.Bin(b.choice, list(b.items))
                 for b in heur.first_fit_decreasing(first).bins]
            used = [list(b.used(pb)) for b in bins]
            heur.ffd_pack_into(pb, bins, used, range(half, len(pb.items)))
            per_side.append(([(b.choice, list(b.items)) for b in bins],
                             [[u.hex() for u in row] for row in used],
                             [[r.hex() for r in res]
                              for res in pk.residuals(pb, bins)]))
        assert per_side[0] == per_side[1]
        n_checked += per_side[1] is not None
    assert n_checked >= 10


def test_validate_catches_the_same_faults():
    msgs = []
    for pk, _, slv in SIDES.values():
        pb = _random_problem(pk, 3, max_items=6)
        while not all(it.compatible() for it in pb.items):
            pb = pk.Problem(choices=pb.choices, items=pb.items[:-1])
        sol, _ = slv.solve(pb)
        pk.validate(pb, sol)
        dropped = pk.Solution(bins=[pk.Bin(b.choice, list(b.items[1:]))
                                    for b in sol.bins], cost=sol.cost)
        with pytest.raises(AssertionError) as e:
            pk.validate(pb, dropped)
        msgs.append(str(e.value))
        with pytest.raises(ValueError):
            pk.Problem(choices=pb.choices,
                       items=(pk.Item("bad", ((1.0,),) * len(pb.choices)),))
    assert msgs[0] == msgs[1]


# -- arc-flow ------------------------------------------------------------------


def _sidebar(af):
    items = [af.IntItem((5, 1), 1, "A"), af.IntItem((3, 1), 1, "B"),
             af.IntItem((2, 1), 2, "C")]
    return af.build_graph((7, 3), items)


def _graph_facts(af, g):
    gc = af.compress(g)
    return (len(g.nodes), len(g.arcs), len(gc.nodes), len(gc.arcs),
            sorted(g.nodes), sorted(g.arcs), sorted(gc.arcs),
            sorted(set(af.patterns(g))), sorted(set(af.patterns(gc))),
            af.max_items_per_bin(g), af.min_bins_from_patterns(g))


def test_arcflow_sidebar_graph_matches_reference():
    facts = _graph_facts(arcflow, _sidebar(arcflow))
    assert facts == _graph_facts(ref_arcflow, _sidebar(ref_arcflow))
    n_nodes, _, n_nodes_c, _, *_ = facts
    assert n_nodes_c <= n_nodes
    assert facts[-1] == 2                    # A+C and B+C: two trucks


@pytest.mark.parametrize("seed", range(4))
def test_arcflow_graph_sizes_before_and_after_compress(seed):
    rng = np.random.default_rng(seed)
    for _ in range(6):
        raw = [(int(rng.integers(1, 6)), int(rng.integers(1, 6)),
                int(rng.integers(1, 3))) for _ in range(int(rng.integers(1, 5)))]
        cap = (int(rng.integers(5, 10)), int(rng.integers(5, 10)))
        per_side = []
        for af in (ref_arcflow, arcflow):
            items = [af.IntItem((w, h), d, f"i{i}")
                     for i, (w, h, d) in enumerate(raw)]
            per_side.append(_graph_facts(af, af.build_graph(cap, items)))
        assert per_side[1] == per_side[0]
        assert per_side[1][2] <= per_side[1][0]
    vecs = [tuple(float(v) for v in rng.uniform(0.0, 4.0, 3)) for _ in range(5)]
    assert arcflow.quantize(vecs, (8.0, 4.0, 0.0), levels=50) == \
        ref_arcflow.quantize(vecs, (8.0, 4.0, 0.0), levels=50)


# -- the problem builder: packed and scalar ------------------------------------


def _random_fleet(ns, geo_mod, seed, n):
    """The reference's repair/parity-test fleet on the side ``ns``."""
    rng = np.random.default_rng(seed)
    cams = tuple(sorted(geo_mod.CAMERAS))
    out = []
    for i in range(n):
        cam = cams[int(rng.integers(0, len(cams)))]
        if rng.random() < 0.25:
            fps = round(float(rng.uniform(0.1, 1.5)), 3)
            out.append(ns.Stream(f"vgg-{i}", ns.PROGRAMS["VGG16"], fps,
                                 camera=cam))
        else:
            fps = round(float(rng.uniform(0.2, 6.0)), 3)
            out.append(ns.Stream(f"zf-{i}", ns.PROGRAMS["ZF"], fps,
                                 camera=cam))
    return out


def _problem_facts(pb):
    return ([(c.key, c.type_name, c.location, c.capacity, c.price.hex(),
              c.has_gpu, c.market) for c in pb.choices],
            [(it.key, tuple(it.requirements)) for it in pb.items])


BUILD_KW = ({"rtt_filter": True}, {"target_fps": 1.0, "rtt_filter": True},
            {"gpu_only": True}, {"cpu_only": True},
            {"locations": ["us-east-1", "eu-west-1"]})


@pytest.mark.parametrize("kw", BUILD_KW, ids=lambda kw: "-".join(kw))
def test_build_problem_packed_equals_scalar_and_reference(kw):
    streams = _random_fleet(P, geo, 1, 60)
    ref_streams = _random_fleet(R, ref_geo, 1, 60)
    cat, ref_cat = P.fig6_catalog(), R.fig6_catalog()
    pa = P.build_problem(streams, cat, packed=True, **kw)
    pb = P.build_problem(streams, cat, packed=False, **kw)
    assert packed.get_packed(pa) is not None
    assert packed.get_packed(pb) is None
    facts = _problem_facts(pa)
    assert facts == _problem_facts(pb)
    assert facts == _problem_facts(
        R.build_problem(ref_streams, ref_cat, packed=True, **kw))
    assert facts == _problem_facts(
        R.build_problem(ref_streams, ref_cat, packed=False, **kw))
    # the packed arrays themselves
    pp, ref_pp = packed.get_packed(pa), ref_packed.get_packed(
        R.build_problem(ref_streams, ref_cat, packed=True, **kw))
    for f in ("item_class", "class_req", "class_compat", "class_size",
              "capacity", "prices"):
        np.testing.assert_array_equal(getattr(pp, f), getattr(ref_pp, f))


def test_packed_problem_shares_class_tuples():
    """Items of one class share one requirements tuple (the O(classes x
    choices) construction), and so does the spot-augmented problem."""
    streams = [P.Stream(f"s{i}", P.PROGRAMS["ZF"], 2.0, camera="nyc")
               for i in range(5)]
    pb = P.build_problem(streams, P.fig6_catalog(), rtt_filter=True)
    first = pb.items[0].requirements
    assert all(it.requirements is first for it in pb.items[1:])
    # a problem of eager items that share tuples: the spot twin extends each
    # shared tuple once (keyed by id() while the base items hold them)
    eager = P.Problem(choices=pb.choices, items=tuple(
        P.Item(it.key, it.requirements) for it in pb.items))
    assert packed.get_packed(eager) is None
    aug = packed.augment_problem_with_spot(eager, {"us-east-1": 0.5})
    first = aug.items[0].requirements
    assert len(first) > len(pb.choices)
    assert all(it.requirements is first for it in aug.items[1:])


@pytest.mark.parametrize("seed", range(6))
def test_ffd_plans_packed_scalar_and_reference(seed):
    n = 5 + 23 * seed
    streams = _random_fleet(P, geo, seed, n)
    plan = strategies.ffd_greedy(streams, P.fig6_catalog())
    with packed.scalar_mode():
        plan_s = strategies.ffd_greedy(streams, P.fig6_catalog())
    ref_plan = ref_strategies.ffd_greedy(_random_fleet(R, ref_geo, seed, n),
                                         R.fig6_catalog())
    assert plan.signature() == plan_s.signature() == ref_plan.signature()
    assert plan.hourly_cost.hex() == ref_plan.hourly_cost.hex()
    P.validate(plan.problem, plan.solution)      # the packed validator
    P.validate(plan_s.problem, plan_s.solution)  # the scalar one


def test_packed_validate_catches_a_double_assignment():
    streams = _random_fleet(P, geo, 2, 30)
    plan = strategies.ffd_greedy(streams, P.fig6_catalog())
    assert packed.get_packed(plan.problem) is not None
    bins = [P.Bin(b.choice, list(b.items)) for b in plan.solution.bins]
    bins[-1].items.append(bins[0].items[0])
    with pytest.raises(AssertionError, match="assigned twice"):
        P.validate(plan.problem, P.Solution(bins=bins,
                                            cost=plan.solution.cost))


@pytest.mark.parametrize("name", ("solve", "brute_force"))
def test_solver_budgets_match_reference(name):
    """The node and wall-clock budgets (and ``brute_force``'s size limit)
    are the reference's."""
    import inspect
    assert inspect.signature(getattr(solver, name)).parameters.keys() == \
        inspect.signature(getattr(ref_solver, name)).parameters.keys()
    assert [p.default for p in inspect.signature(
        getattr(solver, name)).parameters.values()] == \
        [p.default for p in inspect.signature(
            getattr(ref_solver, name)).parameters.values()]
