"""The paper's tables and figures on the port's sweep engine (port of
``benchmarks/paper_figs.py``): fig3a, fig3b, fig4_bits, fig56, table3 and
thm3 at the reference's N, d, rounds and step sizes, every grid one
``run_sweep`` (``experiments.timed_sweep``, ``backend="cuda"``); fig4_bits,
table3 and thm3 are ``experiments``' own grids.

Each row's value is the wall time per simulated round per grid cell (the
host clock around the sweep, which ends in a copy to the host); ``derived``
carries the figure's headline number and, where the reference checks a
claim, the check.  ``fast`` cuts every grid to its first variant and a
tenth of the rounds, as the reference's ``--fast`` does.  The problems come
from the port's own generators, so their numbers differ from the
reference's; the claims do not depend on them.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch import experiments as ex
from repro_torch.bench import Context, Row
from repro_torch.core import artemis as art
from repro_torch.core import federated as fed

N, D = 20, 20


def fig3a_saturation(ctx: Context) -> List[Row]:
    """Fig 3a / S7: LSR i.i.d., sigma_* != 0: every variant saturates, double
    compression above single, above SGD."""
    variants = ["sgd", "qsgd", "diana", "biqsgd", "artemis"]
    iters, tail = (300, 50) if ctx.fast else (3000, 300)
    prob, _ = fed.make_lsr_problem(123, n_workers=N, n_per=200, d=D,
                                   noise=0.4, device=ctx.device)
    opt = float(prob.global_loss(prob.solve_opt()))
    # one shared step size, stable for every variant
    gamma = 0.8 * fed.gamma_max(prob, art.variant_config("artemis", D, N))
    variants = variants[:1] if ctx.fast else variants
    cfgs = [art.variant_config(v, D, N) for v in variants]
    res, us = ex.timed_sweep(prob, cfgs, [gamma], [0], iters, batch=1,
                             eval_every=10)
    sat = {v: float(np.mean(res.losses[i, 0, 0, -tail // 10:])) - opt
           for i, v in enumerate(variants)}
    rows = [(f"fig3a/{v}", us, f"saturation={s:.3e}")
            for v, s in sat.items()]
    if not ctx.fast:
        ok = sat["sgd"] < sat["qsgd"] < sat["biqsgd"]
        rows.append(("fig3a/ordering", 0.0,
                     f"sgd<single<double={'yes' if ok else 'NO'}"))
    return rows


def fig3b_memory_noniid(ctx: Context) -> List[Row]:
    """Fig 3b / S9: non-i.i.d. logistic, full batch (sigma_* = 0): memory
    converges linearly; memoryless saturates."""
    variants = ["biqsgd", "artemis", "qsgd", "diana", "sgd"]
    iters = 80 if ctx.fast else 800
    prob = fed.make_logistic_problem(3, n_workers=N, n_per=200, d=2,
                                     device=ctx.device)
    opt = float(prob.global_loss(prob.solve_opt()))
    gamma = 1.0 / (2 * prob.smoothness())
    variants = variants[:1] if ctx.fast else variants
    cfgs = [art.variant_config(v, 2, N) for v in variants]
    res, us = ex.timed_sweep(prob, cfgs, [gamma], [0], iters,
                             full_batch=True, eval_every=10)
    exc = {v: float(res.losses[i, 0, 0, -1]) - opt
           for i, v in enumerate(variants)}
    rows = [(f"fig3b/{v}", us, f"excess={e:.3e}") for v, e in exc.items()]
    if not ctx.fast:
        ok = exc["artemis"] < exc["biqsgd"]
        rows.append(("fig3b/memory", 0.0,
                     f"artemis_below_biqsgd={'yes' if ok else 'NO'}"))
    return rows


def fig4_bits(ctx: Context) -> List[Row]:
    """Fig 4 / S11-S12: loss against communicated bits on the clustered
    non-i.i.d. problem: the bits each variant spends to halve the excess
    loss (``experiments.fig4_bits``)."""
    variants = ex.FIG4_VARIANTS[:1] if ctx.fast else ex.FIG4_VARIANTS
    res = ex.fig4_bits(ctx.device, variants=variants,
                       iters=60 if ctx.fast else 600)
    return [(f"fig4/{v}", res["us_per_round_cell"],
             f"bits_to_half_loss={b:.3e}")
            for v, b in res["bits_to_half_loss"].items()]


def fig56_partial_participation(ctx: Context) -> List[Row]:
    """Fig 5 against Fig 6: PP1 saturates even without compression; PP2
    converges linearly (sigma_* = 0, full gradients, non-i.i.d.)."""
    iters, tail = (80, 5) if ctx.fast else (800, 5)
    prob = fed.make_logistic_problem(7, n_workers=N, n_per=200, d=2,
                                     device=ctx.device)
    opt = float(prob.global_loss(prob.solve_opt()))
    gamma = 1.0 / (2 * prob.smoothness())
    combos = [("pp1", "sgd-mem"), ("pp1", "artemis"),
              ("pp2", "sgd-mem"), ("pp2", "artemis")]
    combos = combos[:1] if ctx.fast else combos
    cfgs = [art.variant_config(v, 2, N, p=0.5, pp_mode=m) for m, v in combos]
    res, us = ex.timed_sweep(prob, cfgs, [gamma], [0], iters,
                             full_batch=True, eval_every=10)
    exc = {c: float(np.mean(res.losses[i, 0, 0, -tail:])) - opt
           for i, c in enumerate(combos)}
    rows = [(f"fig56/{m}/{v}", us, f"excess={e:.3e}")
            for (m, v), e in exc.items()]
    if not ctx.fast:
        ok = exc[("pp2", "artemis")] < exc[("pp1", "artemis")]
        rows.append(("fig56/pp2_below_pp1", 0.0,
                     f"artemis_pp2<pp1={'yes' if ok else 'NO'}"))
    return rows


def table3_gamma_max(ctx: Context) -> List[Row]:
    """Table 3: the theory's gamma_max is sufficient for convergence; the
    empirical stability edge from a gamma axis of 1x .. 128x, one sweep per
    variant (``experiments.table3_gamma_max``)."""
    res = ex.table3_gamma_max(
        ctx.device, variants=["sgd"] if ctx.fast else
        ["sgd", "qsgd", "artemis"], iters=40 if ctx.fast else 400,
        n_mults=1 if ctx.fast else 8)
    return [(f"table3/{v}", r["us_per_round_cell"],
             f"theory_gmax_converges={'yes' if r['converges'] else 'NO'} "
             f"empirical/theory~{r['empirical_over_theory']:.0f}x")
            for v, r in res["variants"].items()]


def thm3_variance_lower_bound(ctx: Context) -> List[Row]:
    """Thm 3: the asymptotic variance grows with omega_up and omega_dwn:
    sparsification with a smaller q saturates higher
    (``experiments.thm3_variance_lower_bound``)."""
    res = ex.thm3_variance_lower_bound(
        ctx.device, qs=[1.0] if ctx.fast else [1.0, 0.5, 0.25],
        iters=80 if ctx.fast else 800, tail=2 if ctx.fast else 10)
    us = res["us_per_round_cell"]
    rows = [(f"thm3/sparsify_q={q}", us, f"saturation={s:.3e}")
            for q, s in res["saturation"].items()]
    if res["monotone"] is not None:
        rows.append(("thm3/monotone", 0.0,
                     f"omega_up_increases_variance="
                     f"{'yes' if res['monotone'] else 'NO'}"))
    return rows


SUITES = [("fig3a", fig3a_saturation), ("fig3b", fig3b_memory_noniid),
          ("fig4_bits", fig4_bits), ("fig56", fig56_partial_participation),
          ("table3", table3_gamma_max), ("thm3", thm3_variance_lower_bound)]
