"""CLI for the port's observability layer (port of ``repro/obs/__main__.py``,
DESIGN.md §11).

  PYTHONPATH=src python -m repro_torch.obs summary  events.jsonl
  PYTHONPATH=src python -m repro_torch.obs validate events.jsonl
  PYTHONPATH=src python -m repro_torch.obs diff     a.jsonl b.jsonl
  PYTHONPATH=src python -m repro_torch.obs dashboard events.jsonl [-o dash.md]
  PYTHONPATH=src python -m repro_torch.obs bench-append LEDGER NAME VALUE UNIT
  PYTHONPATH=src python -m repro_torch.obs bench-check  LEDGER
  PYTHONPATH=src python -m repro_torch.obs smoke -o obs_out/ [--device cpu]

``smoke`` runs the port's small instrumented sweep grid (telemetry on, one
faulted variant) on the device given (CUDA unless ``--device`` names
another), captures a Chrome trace, and writes a schema-valid
``events.jsonl`` and ``dashboard.md`` under ``-o``; it appends to a bench
ledger only when ``--ledger`` names one.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from repro_torch.obs import bench, events, spans

_BLOCKS = "▁▂▃▄▅▆▇█"


def sparkline(xs, width: int = 40) -> str:
    """Unicode sparkline of a series, log-scaled when it spans decades."""
    xs = np.asarray(xs, np.float64)
    xs = xs[np.isfinite(xs)]
    if xs.size == 0:
        return "(no finite data)"
    if xs.size > width:
        idx = np.linspace(0, xs.size - 1, width).round().astype(int)
        xs = xs[idx]
    pos = xs[xs > 0]
    if pos.size and pos.max() / max(pos.min(), 1e-300) > 1e3:
        xs = np.log10(np.maximum(xs, pos.min()))
    lo, hi = xs.min(), xs.max()
    if hi - lo < 1e-12:
        return _BLOCKS[0] * xs.size
    q = ((xs - lo) / (hi - lo) * (len(_BLOCKS) - 1)).round().astype(int)
    return "".join(_BLOCKS[i] for i in q)


def _fmt(v, nd=4):
    if v is None:
        return "—"
    if isinstance(v, float):
        return f"{v:.{nd}g}"
    return str(v)


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------

def cmd_summary(args) -> int:
    s = events.summarize(events.read_events(args.log))
    if args.json:
        print(json.dumps(s, indent=2, default=str))
        return 0
    print(f"run {s['run_id']}  sha {s['git_sha']}  status {s['status']}"
          f"  wall {_fmt(s['wall_s'])}s")
    print("events: " + ", ".join(f"{k}={v}"
                                 for k, v in sorted(s["events"].items())))
    if s["rollbacks"]:
        print(f"rollbacks: {s['rollbacks']}")
    for key, c in s["cells"].items():
        line = (f"cell {key} [{c['label']}] iter {c.get('iter')} "
                f"loss {_fmt(c.get('loss'))} bits {_fmt(c.get('bits'))} "
                f"dist {_fmt(c.get('dist'))}")
        m = c.get("metrics") or {}
        extras = [f"{n}={_fmt(m[n])}" for n in
                  ("active", "mem_drift", "err_up", "rollbacks") if n in m]
        if extras:
            line += "  |  " + " ".join(extras)
        print(line)
    for name, a in sorted(s["spans"].items(), key=lambda kv: -kv[1]["total_s"]):
        print(f"span {name}: {a['count']}x  total {a['total_s']:.3f}s")
    errs = s["schema_errors"]
    if errs:
        print(f"SCHEMA ERRORS ({len(errs)}):")
        for e in errs[:20]:
            print("  " + e)
        return 1
    return 0


def cmd_validate(args) -> int:
    evs = events.read_events(args.log)
    errs = events.validate_events(evs)
    for e in errs:
        print(e)
    print(f"{args.log}: {len(evs)} events, {len(errs)} schema errors")
    return 1 if errs else 0


def cmd_diff(args) -> int:
    sa = events.summarize(events.read_events(args.a))
    sb = events.summarize(events.read_events(args.b))
    print(f"A: run {sa['run_id']} sha {sa['git_sha']}  "
          f"B: run {sb['run_id']} sha {sb['git_sha']}")
    keys = sorted(set(sa["cells"]) | set(sb["cells"]))
    rc = 0
    for k in keys:
        ca, cb = sa["cells"].get(k), sb["cells"].get(k)
        if ca is None or cb is None:
            print(f"cell {k}: only in {'B' if ca is None else 'A'}")
            rc = 1
            continue
        for f in ("loss", "bits", "dist"):
            va, vb = ca.get(f), cb.get(f)
            if va is None or vb is None:
                continue
            rel = 0.0 if va == vb else (vb - va) / max(abs(va), 1e-30)
            mark = ""
            if abs(rel) > args.tol:
                mark = "  <-- drift"
                rc = 1
            print(f"cell {k} [{ca['label']}] {f}: {_fmt(va)} -> {_fmt(vb)} "
                  f"({rel:+.2%}){mark}")
    for name in sorted(set(sa["spans"]) | set(sb["spans"])):
        ta = sa["spans"].get(name, {}).get("total_s", 0.0)
        tb = sb["spans"].get(name, {}).get("total_s", 0.0)
        print(f"span {name}: {ta:.3f}s -> {tb:.3f}s")
    return rc


def render_dashboard(evs) -> str:
    """Markdown dashboard: loss curves, the paper's bits-vs-accuracy
    frontier, wire model-vs-measured, span table."""
    s = events.summarize(evs)
    series = {}
    for rec in evs:
        if rec.get("ev") != "eval":
            continue
        series.setdefault(events._cell_key(rec), []).append(rec)
    out = [f"# repro_torch.obs dashboard — run `{s['run_id']}`",
           "",
           f"* git sha: `{s['git_sha']}`  status: **{s['status']}**  "
           f"wall: {_fmt(s['wall_s'])}s",
           f"* events: " + ", ".join(f"{k}={v}" for k, v
                                     in sorted(s["events"].items())),
           f"* schema errors: {len(s['schema_errors'])}  "
           f"rollbacks: {s['rollbacks']}", ""]

    out += ["## Loss curves (per grid cell)", "",
            "| cell | variant | final loss | curve |",
            "|---|---|---:|---|"]
    for k in sorted(series):
        rs = sorted(series[k], key=lambda r: r["iter"])
        xs = [r["loss"] for r in rs]
        out.append(f"| {'/'.join(map(str, k))} | {rs[-1]['cell'].get('label')}"
                   f" | {_fmt(xs[-1])} | `{sparkline(xs)}` |")

    out += ["", "## Bits vs. accuracy frontier", "",
            "The paper's Fig. 2-style comparison: total communicated bits "
            "against the loss they bought (final eval point, per cell, "
            "sorted by bits).", "",
            "| variant | cell | total bits | final loss | final dist |",
            "|---|---|---:|---:|---:|"]
    rows = []
    for k in sorted(series):
        r = max(series[k], key=lambda r: r["iter"])
        rows.append((r["bits"], r["cell"].get("label"),
                     "/".join(map(str, k)), r["loss"], r["dist"]))
    for bits, label, cell, loss, dist in sorted(rows):
        out.append(f"| {label} | {cell} | {bits:.3g} | {_fmt(loss)} "
                   f"| {_fmt(dist)} |")

    tel_rows = [(k, max(series[k], key=lambda r: r["iter"]).get("metrics"))
                for k in sorted(series)]
    tel_rows = [(k, m) for k, m in tel_rows if m]
    if tel_rows:
        names = [n for n in ("active", "straggler_drops", "blowup_hits",
                             "wire_scrubbed", "err_up", "mem_drift",
                             "rollbacks") if n in tel_rows[0][1]]
        out += ["", "## Telemetry (final eval point)", "",
                "| cell | " + " | ".join(names) + " |",
                "|---|" + "---:|" * len(names)]
        for k, m in tel_rows:
            out.append("| " + "/".join(map(str, k)) + " | "
                       + " | ".join(_fmt(m[n]) for n in names) + " |")

    wires = [r for r in evs if r.get("ev") == "wire"]
    if wires:
        out += ["", "## Wire bytes: model vs. measured", "",
                "| wire | reduce | model B/step | measured B/step | rel err |",
                "|---|---|---:|---:|---:|"]
        for r in wires:
            mo, me = r["model_bytes"], r["measured_bytes"]
            rel = abs(me - mo) / max(abs(mo), 1e-30)
            out.append(f"| {r['wire']} | {r['reduce_impl']} | {mo:.0f} "
                       f"| {me:.0f} | {rel:.2%} |")

    if s["spans"]:
        out += ["", "## Spans", "", "| span | count | total s |",
                "|---|---:|---:|"]
        for name, a in sorted(s["spans"].items(),
                              key=lambda kv: -kv[1]["total_s"]):
            out.append(f"| {name} | {a['count']} | {a['total_s']:.3f} |")
    return "\n".join(out) + "\n"


def cmd_dashboard(args) -> int:
    md = render_dashboard(events.read_events(args.log))
    if args.out:
        with open(args.out, "w") as f:
            f.write(md)
        print(f"wrote {args.out}")
    else:
        print(md)
    return 0


def cmd_bench_append(args) -> int:
    e = bench.append(args.ledger, args.name, args.value, args.unit,
                     direction=args.direction, tol=args.tol,
                     run_id=args.run_id)
    print(json.dumps(e))
    return 0


def cmd_bench_check(args) -> int:
    verdicts = bench.check(args.ledger, window=args.window)
    bad = 0
    for v in verdicts:
        print(v.describe())
        bad += v.status == "regression"
    print(f"{args.ledger}: {len(verdicts)} metrics, {bad} regressions")
    return 1 if bad else 0


def cmd_smoke(args) -> int:
    """Instrumented end-to-end smoke: sweep grid with telemetry + a faulted
    variant, Perfetto capture, JSONL log, dashboard, bench ledger."""
    import os

    from repro_torch import default_device
    from repro_torch.core import artemis as art
    from repro_torch.core import faults as F
    from repro_torch.core import federated as fed
    from repro_torch.core import sweep as S

    dev = default_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    log_path = os.path.join(args.out, "events.jsonl")
    t_start = time.perf_counter()
    prob, w_star = fed.make_lsr_problem(12, n_workers=10, n_per=60, d=20,
                                        noise=0.0, device=dev)
    fc = F.FaultConfig(blowup_rate=0.05, blowup_value=float("nan"),
                       scrub=True, straggler_rate=0.1,
                       sentinel=1e6, backoff=0.5)
    mk = lambda **kw: art.ArtemisConfig(dim=prob.dim,  # noqa: E731
                                        n_workers=prob.n_workers, **kw)
    cfgs = [mk(up="identity", dwn="identity", alpha=0.0),
            mk(up="squant", dwn="squant", up_kwargs={"s": 1},
               dwn_kwargs={"s": 1}),
            mk(up="squant", dwn="squant", up_kwargs={"s": 1},
               dwn_kwargs={"s": 1}, p=0.5, faults=fc)]
    labels = ["sgd-uncompressed", "artemis-1bit", "artemis-1bit-faulted"]

    spans.reset()
    with events.EventLog(log_path, echo=args.echo) as log:
        spans.install_sink(log)
        try:
            log.start(config={"iters": args.iters, "eval_every": args.every,
                              "grid": labels, "gamma": args.gamma,
                              "device": str(dev)},
                      fingerprint=f"obs-smoke-d{prob.dim}")
            trace_dir = os.path.join(args.out, "trace")
            with spans.profile(trace_dir):
                with spans.span("obs/sweep"):
                    res = S.run_sweep(prob, cfgs, [args.gamma], [0, 1],
                                      args.iters, eval_every=args.every,
                                      w_star=w_star, telemetry=True,
                                      device=dev)
            n_ev = events.record_sweep(log, res, cfgs=cfgs, labels=labels)
            wall = time.perf_counter() - t_start
            log.end(status="ok", wall_s=wall, traces=res.traces,
                    eval_events=n_ev)
        finally:
            spans.uninstall_sink()

    evs = events.read_events(log_path)
    errs = events.validate_events(evs)
    md = render_dashboard(evs)
    dash = os.path.join(args.out, "dashboard.md")
    with open(dash, "w") as f:
        f.write(md)
    arts = spans.perfetto_artifacts(trace_dir)

    if args.ledger:
        run_id = evs[0]["run_id"]
        tel = res.telemetry
        faulted_bits = float(res.bits[2, 0, 0, -1])
        bench.append(args.ledger, "obs_smoke.wall_s",
                     time.perf_counter() - t_start, "s", tol=1.0,
                     run_id=run_id)
        bench.append(args.ledger, "obs_smoke.traces", res.traces, "compiles",
                     tol=0.0, run_id=run_id)
        bench.append(args.ledger, "obs_smoke.schema_errors", len(errs),
                     "errors", tol=0.0, run_id=run_id)
        bench.append(args.ledger, "obs_smoke.final_loss_1bit",
                     float(res.losses[1, 0, 0, -1]), "nll", tol=0.05,
                     run_id=run_id)
        bench.append(args.ledger, "obs_smoke.bits_faulted", faulted_bits,
                     "bits", tol=0.05, run_id=run_id)
        bench.append(args.ledger, "obs_smoke.blowup_hits",
                     float(tel["blowup_hits"][2, 0, 0, -1]), "workers",
                     tol=0.0, run_id=run_id)

    print(f"events: {log_path} ({len(evs)} events, {len(errs)} schema "
          f"errors)")
    print(f"dashboard: {dash}")
    print(f"perfetto: {arts[0] if arts else 'MISSING'}")
    if errs or not arts:
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("summary", help="digest one event log")
    p.add_argument("log")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_summary)

    p = sub.add_parser("validate", help="schema-check one event log")
    p.add_argument("log")
    p.set_defaults(fn=cmd_validate)

    p = sub.add_parser("diff", help="compare two runs' event logs")
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--tol", type=float, default=0.05,
                   help="relative drift that counts as a difference")
    p.set_defaults(fn=cmd_diff)

    p = sub.add_parser("dashboard", help="render the markdown dashboard")
    p.add_argument("log")
    p.add_argument("-o", "--out", default=None)
    p.set_defaults(fn=cmd_dashboard)

    p = sub.add_parser("bench-append", help="append one ledger entry")
    p.add_argument("ledger")
    p.add_argument("name")
    p.add_argument("value", type=float)
    p.add_argument("unit")
    p.add_argument("--direction", default="lower",
                   choices=list(bench.DIRECTIONS))
    p.add_argument("--tol", type=float, default=0.25)
    p.add_argument("--run-id", default="")
    p.set_defaults(fn=cmd_bench_append)

    p = sub.add_parser("bench-check", help="regression-gate the ledger")
    p.add_argument("ledger")
    p.add_argument("--window", type=int, default=bench.WINDOW)
    p.set_defaults(fn=cmd_bench_check)

    p = sub.add_parser("smoke", help="instrumented smoke sweep")
    p.add_argument("-o", "--out", default="obs_out")
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--every", type=int, default=10)
    p.add_argument("--gamma", type=float, default=0.05)
    p.add_argument("--ledger", default=None,
                   help="a bench ledger to append to (none by default)")
    p.add_argument("--device", default=None,
                   help="the device to run on (default: CUDA)")
    p.add_argument("--echo", action="store_true")
    p.set_defaults(fn=cmd_smoke)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
