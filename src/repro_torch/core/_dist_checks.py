"""Self-checks of the port's distributed runtime (the port of
``repro/core/_dist_checks.py``).

  PYTHONPATH=src python -m repro_torch.core._dist_checks solve_pool --device cpu

Each check holds a distributed path against the port's own single-device
one, on the instances and under the keys of the JAX check of the same
name, and prints one JSON object whose values should all be ``true``. The
mesh axes live in this process (`core.axis.LocalAxis`), as the JAX checks
emulate 8 devices in one. Runs on ``--device`` (default the GPU; raises
when it is missing). ``engine_interpret`` (JAX's Pallas interpret mode)
has no counterpart here.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch.core import distributed as dist_mod
from repro_torch.core import engine
from repro_torch.core import merge as merge_mod
from repro_torch.core import paraqaoa as para_mod
from repro_torch.core import qaoa as qaoa_mod
from repro_torch.core.axis import LocalAxis
from repro_torch.core.graph import (Graph, Problem, cut_value,
                                    independent_set_violations)
from repro_torch.core.partition import (connectivity_preserving_partition,
                                        partition_for_solver)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
# the harness's whole job is comparing impls against the reference
from repro_torch.kernels import ref  # reprolint: disable=dispatch-purity


def check_solve_pool(dev):
    """The pool over data=8 (60 subgraph rows padded to 64) against the
    single-device batch: equal candidates, expectations within 1e-4."""
    g = Graph.erdos_renyi(60, 0.4, seed=0)
    part = connectivity_preserving_partition(g, 6)
    cfg = qaoa_mod.QAOAConfig(n_qubits=11, p_layers=2, opt_steps=10, top_k=2)
    edges, weights, masks = qaoa_mod.pad_subgraph_arrays(part.subgraphs, 11,
                                                         device=dev)
    want = qaoa_mod.solve_subgraph_batch(edges, weights, masks, cfg)
    got = dist_mod.solve_pool(edges, weights, masks, cfg, "data=8")
    return {
        "bitstrings_equal": bool(torch.equal(want.bitstrings, got.bitstrings)),
        "exp_close": bool(torch.allclose(want.expectation, got.expectation,
                                         atol=1e-4)),
    }


def check_sharded_qaoa(dev):
    """One 10-qubit circuit sharded over 4 and 8 shards, both schedules,
    against the flat statevector: ⟨cut⟩ within 1e-4, the top-1's
    probability within 1e-6 (exact ties may order the indices either
    way), the top-4 probabilities within 1e-5."""
    out = {}
    n = 10
    g = Graph.erdos_renyi(n, 0.5, seed=1)
    e, w = g.edges.to(dev), g.weights.to(dev)
    gammas = torch.tensor([0.3, 0.55], device=dev)
    betas = torch.tensor([0.9, 0.4], device=dev)
    cutv = ref.cutvals(n, e[None], w[None])
    re, im = qaoa_mod.qaoa_statevector(cutv, n, gammas[None], betas[None])
    want_exp = float(ref.expectation(re, im, cutv)[0])
    probs = (re * re + im * im)[0]
    want_v = torch.sort(probs, descending=True, stable=True).values[:4]
    for axis_size in (4, 8):
        for schedule in ("faithful", "alternating"):
            res = dist_mod.sharded_qaoa(e, w, n, gammas, betas,
                                        LocalAxis(axis_size), top_k=4,
                                        schedule=schedule)
            key = f"d{axis_size}_{schedule}"
            out[key + "_exp_close"] = bool(abs(float(res.expectation) - want_exp)
                                           <= 1e-4)
            top1 = int(res.bitstrings[0])
            out[key + "_top1_match"] = bool(abs(float(probs[top1]) - float(want_v[0]))
                                            <= 1e-6)
            out[key + "_probs_close"] = bool(torch.allclose(
                torch.sort(res.probs).values, torch.sort(want_v).values, atol=1e-5))
    return out


def check_merge_sharded(dev):
    """The merge striped over data=8: the value at width 16 equals the
    exhaustive single-device merge's, its assignment achieves it, and
    `striped_beam_width` gives the exact value at split levels 1-3."""
    g = Graph.erdos_renyi(32, 0.5, seed=2)
    part = connectivity_preserving_partition(g, 4)
    rng = np.random.default_rng(0)
    k = 2
    cand = rng.integers(0, 2 ** min(part.sizes), size=(part.m, k))
    plan = merge_mod.build_merge_plan(part, cand, k, device=dev)
    want = float(merge_mod.merge_scan(
        plan, merge_mod.exact_beam_width(k, part.m)).cut_value)
    assign, val = dist_mod.merge_sharded(plan, 16, "data=8", split_level=1)
    achieved = float(cut_value(g, assign.cpu()[: g.n]))
    out = {
        "val_matches_exact": bool(abs(float(val) - want) < 1e-3),
        "assignment_achieves_val": bool(abs(achieved - float(val)) < 1e-3),
    }
    for sl in (1, 2, 3):
        width = merge_mod.striped_beam_width(k, part.m, 8, sl)
        _, v = dist_mod.merge_sharded(plan, width, "data=8", split_level=sl)
        out[f"split{sl}_exact_at_proven_width"] = bool(abs(float(v) - want) < 1e-3)
    return out


def check_engine_grad(dev):
    """Autograd through the sharded evolution against the flat gradient
    (within 2e-3 of the gradient scale), and the sharded Adam ascent: it
    beats the ramp and lands on the flat optimizer's angles (1e-4)."""
    out = {}
    n = 10
    g = Graph.erdos_renyi(n, 0.5, seed=3)
    e, w = g.edges.to(dev)[None], g.weights.to(dev)[None]
    gammas, betas = qaoa_mod.linear_ramp_init(3, 0.75, device=dev)

    def grads(expectation_of):
        leaves = [x[None].clone().requires_grad_(True) for x in (gammas, betas)]
        return torch.autograd.grad(expectation_of(*leaves).sum(), leaves)

    cutv = ops.cutvals(n, e, w)
    want = grads(lambda gm, bt: qaoa_mod.qaoa_expectation((gm, bt), cutv, n))
    scale = max(float(x.abs().max()) for x in want)
    for d in (2, 4):
        layout = engine.ShardedLayout(n=n, axis=LocalAxis(d))
        cut = engine.cut_table(layout, e, w)

        def sharded_exp(gm, bt):
            re, im, in_b = engine.evolve(layout, cut, gm, bt)
            return engine.expectation(layout, re, im, cut, in_b)

        got = grads(sharded_exp)
        err = max(float((a - b).abs().max()) for a, b in zip(want, got))
        out[f"d{d}_grad_close"] = bool(err <= 2e-3 * max(scale, 1.0))

    axis = LocalAxis(4)
    r_ramp = dist_mod.sharded_qaoa(e[0], w[0], n, gammas, betas, axis)
    r_opt = dist_mod.sharded_qaoa(e[0], w[0], n, gammas, betas, axis,
                                  opt_steps=30)
    out["ascent_beats_ramp"] = bool(float(r_opt.expectation)
                                    >= float(r_ramp.expectation))
    cfg = qaoa_mod.QAOAConfig(n_qubits=n, p_layers=3, opt_steps=30)
    p_flat = qaoa_mod.optimize_params(cutv, n, cfg)
    out["ascent_matches_flat_optimum"] = bool(all(
        torch.allclose(a[0], b, atol=1e-4)
        for a, b in zip(p_flat, (r_opt.gammas, r_opt.betas))))
    return out


def check_solve_distributed(dev):
    """`solve_distributed` against the single-device `solve`: on data=4
    the same cut and assignment, with the striped merge engaged; on
    data=2,model=4 at opt_steps=0 the cut of the flat solve at the lifted
    budget 10 on the same partition."""
    g = Graph.erdos_renyi(48, 0.3, seed=7)
    cfg = para_mod.ParaQAOAConfig(n_qubits=8, top_k=2, p_layers=2, opt_steps=10)
    want = para_mod.solve(g, cfg, device=dev)
    got = dist_mod.solve_distributed(g, cfg, {"data": 4}, device=dev)
    out = {
        "pool_cut_matches_single": bool(got.cut_value == want.cut_value),
        "pool_assignment_matches_single": bool(np.array_equal(got.assignment,
                                                              want.assignment)),
        "striped_merge_engaged": bool(got.report.extra["merge_shards"] == 4),
        "assignments_consistent": bool(
            float(cut_value(g, torch.as_tensor(got.assignment))) == got.cut_value),
    }
    cfg0 = dataclasses.replace(cfg, opt_steps=0)
    part = partition_for_solver(g, 10)  # the budget lifted by log2(model) = 2
    want0 = para_mod.solve(g, dataclasses.replace(cfg0, n_qubits=10),
                           partition=part, device=dev)
    got0 = dist_mod.solve_distributed(g, cfg0, {"data": 2, "model": 4},
                                      device=dev)
    out["model_cut_matches_lifted_single"] = bool(got0.cut_value == want0.cut_value)
    out["model_routed_subproblems"] = bool(
        got0.report.extra["sharded_subproblems"] > 0)
    return out


def check_problem_distributed(dev):
    """Linear terms through the data axis: a QUBO on data=4 gives the
    single-device value and assignment exactly, and an MIS with 60 refine
    steps its value and a valid independent set."""
    rng = np.random.default_rng(17)
    n = 48
    e = np.array([(i, j) for i in range(n) for j in range(i + 1, n)
                  if rng.random() < 0.15], dtype=np.int32)
    q = rng.normal(size=e.shape[0]).astype(np.float32)
    h = rng.normal(size=n).astype(np.float32)
    prob = Problem.qubo(n, e, q, linear=h, offset=0.25)
    cfg = para_mod.ParaQAOAConfig(n_qubits=8, top_k=2, p_layers=2, opt_steps=10)
    want = para_mod.solve(prob, cfg, device=dev)
    got = dist_mod.solve_distributed(prob, cfg, {"data": 4}, device=dev)
    out = {
        "qubo_cut_matches_single": bool(got.cut_value == want.cut_value),
        "qubo_assignments_equal": bool(np.array_equal(got.assignment,
                                                      want.assignment)),
    }
    g = Graph.erdos_renyi(40, 0.12, seed=9)
    mis = Problem.mis(g)
    cfg_r = dataclasses.replace(cfg, refine_steps=60)
    want_m = para_mod.solve(mis, cfg_r, device=dev)
    got_m = dist_mod.solve_distributed(mis, cfg_r, {"data": 4}, device=dev)
    out["mis_cut_matches_single"] = bool(got_m.cut_value == want_m.cut_value)
    out["mis_valid_independent_set"] = bool(
        independent_set_violations(g, got_m.assignment) == 0)
    return out


def check_service_mesh(dev):
    """Service-backend parity (``_dist_checks.py:404-457`` of the
    reference): the same request mix through the single-device
    `LocalBackend` and through `MeshBackend` (`solve_pool` over data=4)
    gives bit-identical cuts and assignments, and every request not served
    from the cache equals a solo `solve()` on its planned knobs.
    Recalibration is off so both services plan alike (with it on, the
    knobs depend on the clock)."""
    from repro_torch.service import SLA, ServiceConfig, SolveService
    from repro_torch.service.workload import request_mix, tenant_mix

    graphs = request_mix(6, (30, 60), 0.2, 0.25, seed=3)
    tenants = tenant_mix(6, 2, seed=3)
    sla = SLA(deadline_s=20.0)

    def run_service(mesh):
        svc = SolveService(ServiceConfig(
            batch_slots=8, max_qubits=8, mesh=mesh, max_inflight=2,
            recalibrate=False, device=str(dev)))
        rids = [svc.submit(g, sla, tenant=t) for g, t in zip(graphs, tenants)]
        svc.drain()
        return svc, rids

    svc_l, rids_l = run_service(None)
    svc_m, rids_m = run_service("data=4")
    out = {"backends_parity": True, "solo_parity": True}
    for g, rl, rm in zip(graphs, rids_l, rids_m):
        ra, rb = svc_l.results[rl], svc_m.results[rm]
        out["backends_parity"] &= bool(
            ra.cut_value == rb.cut_value
            and np.array_equal(ra.assignment, rb.assignment))
        if not ra.cached:
            solo = para_mod.solve(g, ra.plan.to_config(), device=dev)
            out["solo_parity"] &= bool(
                ra.cut_value == solo.cut_value
                and np.array_equal(ra.assignment, solo.assignment))
    out["mesh_backend_engaged"] = bool(
        svc_m.backend.describe()["devices"] == 4 and svc_m.stats.dispatches > 0)
    out["tenants_accounted"] = bool(
        set(svc_m.stats.tenants) == set(tenants)
        and sum(t.completed for t in svc_m.stats.tenants.values()) == 6)
    out["async_window_used"] = bool(svc_m.stats.max_inflight_seen >= 2)
    return out


CHECKS = {
    "solve_pool": check_solve_pool,
    "sharded_qaoa": check_sharded_qaoa,
    "merge_sharded": check_merge_sharded,
    "engine_grad": check_engine_grad,
    "solve_distributed": check_solve_distributed,
    "problem_distributed": check_problem_distributed,
    "service_mesh": check_service_mesh,
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="repro_torch.core._dist_checks",
                                 description="Self-checks of the distributed runtime.")
    ap.add_argument("check", choices=sorted(CHECKS))
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    args = ap.parse_args(argv)
    result = CHECKS[args.check](resolve_device(args.device))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
