"""``python -m repro_torch`` -- the port's command-line front door (port of
``repro.cli``).

Subcommands:

* ``monitor``  -- run a monitoring script (``python -m repro_torch monitor
  script.py``) or monitor a named sweep config directly
  (``python -m repro_torch monitor serve --formats html``);
* ``sweep``    -- the config-sweep engine: configs x meshes x algorithms,
  cached, with comparative JSON/CSV/HTML/Perfetto artifacts
  (``--scale-curve`` projects each cell onto fleets instead);
* ``lint``     -- static anti-pattern analysis over a config's (or a saved
  report's) collectives, with modeled savings and CI exit codes
  (``--fail-on warn|error``);
* ``compare``  -- import a device trace (``torch.profiler`` or Perfetto
  JSON, nvprof CSV, JSONL) and compare measured against modeled
  per-collective seconds, with CI exit codes (``--fail-on rel-err=X``);
* ``report``   -- re-export a saved report (``CommReport.save``, a cache
  entry or a sweep document of either package) without recapture;
* ``configs``  -- list the sweepable configs;
* ``cache``    -- inspect or clear the port's on-disk report cache;
* ``dryrun``   -- the production-mesh dry run
  (:mod:`repro_torch.launch.dryrun`; every argument is forwarded to it).

Exit codes are the reference's: 0 done, 1 a failed cell or a ``--fail-on``
threshold reached, 2 a usage error (unknown config, algorithm, mesh,
format or path) with one ``error: ...`` line on stderr.  Logs go to
stderr wherever stdout carries JSON (``--json``).

Captures run on a fake ``cuda`` mesh (no NCCL call, nothing allocated)
unless ``--device cpu`` is passed; a ``cuda`` capture needs a CUDA device,
and there is no quiet fallback.  The reference's ``--devices`` (an XLA flag
that forces host devices) has no meaning here: the mesh's ranks are the
fake process group's.  The reference's ``bench`` (the paper-table
benchmarks) is not ported and not offered.
"""
from __future__ import annotations

import argparse
import os
import sys


def _split(csv: str) -> list[str]:
    return [p.strip() for p in csv.split(",") if p.strip()]


def _device(args) -> str:
    """The capture mesh's device type; ``cuda`` needs a CUDA device."""
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise ValueError("no CUDA device for a cuda capture mesh; pass "
                         "--device cpu to capture on a CPU mesh")
    return args.device


def _jobs(args):
    from repro_torch import sweep as sweep_mod

    try:
        return sweep_mod.resolve_jobs(args.jobs)
    except ValueError:
        raise ValueError(
            f"--jobs wants an int or 'auto', got {args.jobs!r}") from None


def _report_failures(result) -> int:
    print("no cell finished; failures:", file=sys.stderr)
    for f in result.failures:
        print(f"  {f}", file=sys.stderr)
    return 1


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------
def _cmd_monitor(args) -> int:
    if args.target.endswith(".py"):
        # run a monitoring script as __main__; its exceptions keep their
        # traceback instead of being read as CLI usage errors
        import runpy
        import traceback
        if args.formats or args.out != "artifacts":
            print("note: --formats/--out are ignored for script targets -- "
                  "scripts control their own output", file=sys.stderr)
        sys.argv = [args.target] + list(getattr(args, "script_args", []))
        try:
            runpy.run_path(args.target, run_name="__main__")
        except Exception:
            traceback.print_exc()
            return 1
        return 0
    from repro_torch import sweep as sweep_mod

    registry = sweep_mod.available_configs()
    if args.target not in registry:
        print(f"error: {args.target!r} is neither a .py file nor a config; "
              f"known configs: {sorted(registry)}", file=sys.stderr)
        return 2
    result = sweep_mod.run_sweep(
        [args.target], [args.mesh], _split(args.algorithms),
        cache=_cache_from(args), use_cache=not args.no_cache,
        device=_device(args))
    if result.failures:
        print(f"error: {result.failures[0]['error']}", file=sys.stderr)
        return 1
    for rep in result.reports:      # one rendering per requested algorithm
        print(rep.render())
        print()
    if args.formats:
        from repro_torch.core import export
        paths = export.export_comparison(
            result.reports, args.out, _split(args.formats),
            stem=args.target)
        for fmt, path in paths.items():
            print(f"[{fmt}] {path}")
    return 0


def _cmd_sweep(args) -> int:
    from repro_torch import sweep as sweep_mod
    from repro_torch.core import export

    registry = sweep_mod.available_configs()
    unknown = [c for c in _split(args.configs) if c not in registry]
    if unknown:
        print(f"error: unknown config(s) {unknown}; known: "
              f"{sorted(registry)}", file=sys.stderr)
        return 2
    if args.scale_curve:
        return _cmd_scale_curve(args, sweep_mod)
    jobs = _jobs(args)
    result = sweep_mod.run_sweep(
        _split(args.configs), _split(args.meshes), _split(args.algorithms),
        cache=_cache_from(args), use_cache=not args.no_cache, jobs=jobs,
        device=_device(args))
    if not result.reports:
        return _report_failures(result)

    table = result.summary_table(by_link=args.by_link,
                                 by_phase=args.by_phase,
                                 lint=args.lint)
    print()
    print(f"== sweep summary: {len(result.reports)} cells "
          f"({result.captures} captured, {result.cache_hits} cache hits) ==")
    print(table)
    result.artifacts = export.export_comparison(
        result.reports, args.out, _split(args.formats), stem="sweep")
    summary_path = os.path.join(args.out, "summary.txt")
    with open(summary_path, "w") as f:
        f.write(table + "\n")
    result.artifacts["summary"] = summary_path
    print()
    for fmt, path in sorted(result.artifacts.items()):
        print(f"[{fmt}] {path}")
    if result.failures:
        print(f"\n{len(result.failures)} cell(s) failed:", file=sys.stderr)
        for f in result.failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    return 0


def _cmd_scale_curve(args, sweep_mod) -> int:
    """``sweep --scale-curve``: base-mesh monitoring + fleet projection."""
    from repro_torch import scale
    from repro_torch.core.export import csv_exporter, html_exporter

    try:
        device_counts = [int(p) for p in _split(args.scale_points)]
    except ValueError:
        print(f"error: --scale-points wants comma-separated ints, got "
              f"{args.scale_points!r}", file=sys.stderr)
        return 2
    result, points = sweep_mod.run_scale_curve(
        _split(args.configs), _split(args.meshes), _split(args.algorithms),
        device_counts=device_counts, cache=_cache_from(args),
        use_cache=not args.no_cache, jobs=_jobs(args), device=_device(args))
    if not result.reports:
        return _report_failures(result)
    table = scale.scale_table(points)
    print()
    print(f"== scale curves: {len(points)} points over "
          f"{len(result.reports)} base cells ==")
    print(table)
    rows = [p.row() for p in points]
    result.artifacts["scale_csv"] = csv_exporter.export_scale_csv(
        rows, os.path.join(args.out, "scale_curve.csv"))
    result.artifacts["scale_html"] = html_exporter.export_scale_html(
        rows, os.path.join(args.out, "scale_curve.html"))
    print()
    for fmt, path in sorted(result.artifacts.items()):
        print(f"[{fmt}] {path}")
    if result.failures:
        print(f"\n{len(result.failures)} cell(s) failed:", file=sys.stderr)
        for f in result.failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    return 0


def _cmd_lint(args) -> int:
    """``lint <config-or-report.json>``: print findings, exit 0 when clean
    (or below ``--fail-on``), 1 when findings reach the threshold, 2 on
    usage errors."""
    import json as json_mod

    from repro_torch.core import reporter
    from repro_torch.core.lint import max_severity, severity_rank

    algs = _split(args.algorithms)
    if args.target.endswith(".json"):
        # a saved report / cache entry / sweep document: lint offline --
        # persisted findings are served as-is for the default binding
        from repro_torch.core import export
        reports = export.load_json_reports(args.target)
        bindings = [(rep, alg) for rep in reports
                    for alg in (algs or [rep.algorithm])]
    else:
        from repro_torch import sweep as sweep_mod
        registry = sweep_mod.available_configs()
        if args.target not in registry:
            print(f"error: unknown config {args.target!r}; known: "
                  f"{sorted(registry)}", file=sys.stderr)
            return 2
        result = sweep_mod.run_sweep(
            [args.target], [args.mesh], algs or ["ring"],
            cache=_cache_from(args), use_cache=not args.no_cache,
            device=_device(args), log=lambda m: print(m, file=sys.stderr))
        if result.failures:
            print(f"error: {result.failures[0]['error']}", file=sys.stderr)
            return 1
        bindings = [(rep, rep.algorithm) for rep in result.reports]

    all_findings = []
    docs = []
    for rep, alg in bindings:
        findings = rep.lint(alg)
        all_findings += findings
        if args.as_json:
            docs.append({"name": rep.name, "algorithm": alg,
                         "max_severity": max_severity(findings),
                         "findings": [f.to_dict() for f in findings]})
        else:
            print(reporter.lint_table(
                findings, title=f"{rep.name} [{alg}]: lint findings"))
            print()
    if args.as_json:
        print(json_mod.dumps(docs[0] if len(docs) == 1 else docs, indent=1))
    if args.fail_on is not None:
        threshold = severity_rank(args.fail_on)
        if any(severity_rank(f.severity) >= threshold
               for f in all_findings):
            return 1
    return 0


def _is_saved_report(path: str) -> bool:
    """Whether ``path`` is a CommReport.save JSON (vs a device trace)."""
    if not path.endswith(".json") or not os.path.exists(path):
        return False
    try:
        with open(path, errors="replace") as f:
            return '"repro.comm_report' in f.read(2048)
    except OSError:
        return False


def _cmd_compare(args) -> int:
    """``compare <trace> [model]``: import a device trace and hold its
    measured per-collective seconds against the cost model.  Exit 0 on a
    finished comparison (below ``--fail-on``), 1 when the ``--fail-on
    rel-err=X`` threshold is hit, 2 on usage errors."""
    import json as json_mod

    from repro_torch.core.trace import FORMATS, load_trace

    def log(msg):
        print(msg, file=sys.stderr)

    threshold = None
    if args.fail_on:
        key, _, val = args.fail_on.partition("=")
        try:
            if key.strip() != "rel-err":
                raise ValueError
            threshold = float(val)
        except ValueError:
            print(f"error: --fail-on wants rel-err=<float> (e.g. "
                  f"rel-err=0.25), got {args.fail_on!r}", file=sys.stderr)
            return 2
    if args.fmt and args.fmt not in FORMATS:
        print(f"error: unknown trace format {args.fmt!r}; valid formats: "
              f"{list(FORMATS)}", file=sys.stderr)
        return 2

    if _is_saved_report(args.trace):
        # a saved report of an earlier import (--save-import): its ops
        # already carry measured_s, no trace frontend needed
        from repro_torch.core import CommReport
        measured = CommReport.load(args.trace)
        log(f"loaded saved report {args.trace}: "
            f"{len(measured.compiled_ops)} collectives, "
            f"{measured.num_devices} devices")
    else:
        imp = load_trace(args.trace, fmt=args.fmt or None,
                         num_devices=args.trace_devices)
        measured = imp.report()
        log(f"imported {args.trace} [{imp.meta.get('source')}]: "
            f"{len(measured.compiled_ops)} collectives, "
            f"{len(measured.host_transfers)} host transfers, "
            f"{measured.num_devices} devices")
    if args.save_import:
        measured.save(args.save_import)
        log(f"[report] {args.save_import}")

    algs = _split(args.algorithms)
    if not args.model:
        # the import's own model (needs a topology, e.g. our own exports)
        models = [(None, a or None) for a in (algs or [None])]
    elif args.model.endswith(".json"):
        from repro_torch.core import export
        reports = export.load_json_reports(args.model)
        models = [(rep, alg) for rep in reports
                  for alg in (algs or [rep.algorithm])]
    else:
        from repro_torch import sweep as sweep_mod
        registry = sweep_mod.available_configs()
        if args.model not in registry:
            print(f"error: unknown config {args.model!r}; known configs: "
                  f"{sorted(registry)}", file=sys.stderr)
            return 2
        result = sweep_mod.run_sweep(
            [args.model], [args.mesh], algs or ["ring"],
            cache=_cache_from(args), use_cache=not args.no_cache,
            device=_device(args), log=log)
        if result.failures:
            print(f"error: {result.failures[0]['error']}", file=sys.stderr)
            return 1
        models = [(rep, rep.algorithm) for rep in result.reports]

    results = []
    for model_rep, alg in models:
        cr = measured.compare(model_rep, algorithm=alg)
        results.append(cr)
        if not args.as_json:
            print(cr.table(
                title=f"== {cr.measured_label} vs {cr.modeled_label} "
                      f"[{cr.algorithm}]: modeled vs measured =="))
            print()
    if args.as_json:
        docs = [cr.to_dict() for cr in results]
        print(json_mod.dumps(docs[0] if len(docs) == 1 else docs,
                             indent=1))
    for fmt in _split(args.formats):
        from repro_torch.core.export import csv_exporter, html_exporter
        stem = os.path.splitext(os.path.basename(args.trace))[0]
        if fmt == "csv":
            path = csv_exporter.export_compare_csv(
                results[0], os.path.join(args.out, f"{stem}_compare.csv"))
        elif fmt == "html":
            path = html_exporter.export_compare_html(
                results, os.path.join(args.out, f"{stem}_compare.html"))
        else:
            print(f"error: unknown compare export format {fmt!r}; valid "
                  f"formats: ['csv', 'html']", file=sys.stderr)
            return 2
        log(f"[{fmt}] {path}")
    if threshold is not None:
        worst = max((cr.max_rel_err() or 0.0) for cr in results)
        if worst > threshold:
            log(f"fail: max rel err {worst:.3f} exceeds --fail-on "
                f"threshold {threshold:.3f}")
            return 1
    return 0


def _cmd_report(args) -> int:
    from repro_torch.core import export

    reports = export.load_json_reports(args.path)   # report, cache entry,
    if args.render:                                 # or sweep document
        for rep in reports:
            print(rep.render())
            print()
    stem = os.path.splitext(os.path.basename(args.path))[0]
    if stem.endswith(".trace"):
        stem = stem[:-len(".trace")]
    if len(reports) == 1:
        for fmt in _split(args.formats):
            path = os.path.join(args.out, stem + export.SUFFIXES.get(fmt, ""))
            export.export_report(reports[0], fmt, path)   # validates fmt
            print(f"[{fmt}] {path}")
    else:
        for fmt, path in export.export_comparison(
                reports, args.out, _split(args.formats), stem=stem).items():
            print(f"[{fmt}] {path}")
    return 0


def _cmd_dryrun(args) -> int:
    from repro_torch.launch import dryrun
    return dryrun.main(args.rest)


def _cmd_configs(args) -> int:
    from repro_torch import sweep as sweep_mod
    from repro_torch.core.reporter import format_table

    rows = [[s.name, s.version, s.description]
            for s in sweep_mod.available_configs().values()]
    print(format_table(rows, ["config", "version", "description"]))
    return 0


def _cmd_cache(args) -> int:
    cache = _cache_from(args)
    if args.clear:
        n = cache.clear()
        print(f"cleared {n} entries from {cache.root}")
        return 0
    entries = cache.entries()
    total = sum(e["size"] for e in entries)
    print(f"cache {cache.root}: {len(entries)} entries, {total:,} bytes")
    for e in entries:
        meta = e.get("meta", {})
        tag = (f"{meta.get('config', '?')} mesh={meta.get('mesh', '?')} "
               f"alg={meta.get('algorithm', '?')}")
        print(f"  {e['key']}  {e['size']:>9,} B  {tag}")
    return 0


def _cache_from(args):
    from repro_torch.core.report_cache import ReportCache
    return ReportCache(root=getattr(args, "cache_dir", None) or None)


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------
def _add_cache_opts(p):
    p.add_argument("--cache-dir", default=None,
                   help="report-cache directory (default "
                        "artifacts/report_cache_torch or "
                        "$REPRO_TORCH_CACHE_DIR)")
    p.add_argument("--no-cache", action="store_true",
                   help="neither read nor write the report cache")


def _add_device_opt(p):
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device type of the fake capture mesh (default "
                        "cuda; cpu captures on a CPU mesh)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="Monitor collective communication among GPUs "
                    "(ComScribe, PyTorch edition).")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("monitor",
                       help="run a monitoring script or one sweep config")
    p.add_argument("target", help="a .py script or a sweep-config name")
    p.add_argument("--mesh", default="4x2", help="mesh spec, e.g. 8 or 4x2")
    p.add_argument("--algorithms", default="ring")
    p.add_argument("--formats", default="",
                   help="also export: comma list of json,csv,html,perfetto")
    p.add_argument("--out", default="artifacts")
    _add_device_opt(p)
    _add_cache_opts(p)
    p.set_defaults(func=_cmd_monitor)

    p = sub.add_parser("sweep", help="sweep configs x meshes x algorithms")
    p.add_argument("--configs", required=True,
                   help="comma list (see `python -m repro_torch configs`)")
    p.add_argument("--meshes", default="4x2",
                   help="comma list of mesh specs, e.g. 8,4x2,2x2x2")
    p.add_argument("--algorithms", default="ring",
                   help="comma list of ring,tree,hierarchical")
    p.add_argument("--by-link", action="store_true", dest="by_link",
                   help="add per-link utilization columns (busiest physical "
                        "ICI/DCN link, the tier-overlapped communication "
                        "time, and its contention-aware bottleneck "
                        "ms) to the summary table")
    p.add_argument("--by-phase", action="store_true", dest="by_phase",
                   help="expand each cell into one row per session phase "
                        "(statistics from that phase's CommView)")
    p.add_argument("--lint", action="store_true",
                   help="add static-lint columns (finding count at worst "
                        "severity + total modeled savings ms) per cell")
    p.add_argument("--scale-curve", action="store_true", dest="scale_curve",
                   help="monitor each cell at its base mesh, then project "
                        "onto synthetic fleet topologies per --scale-points "
                        "device count (sparse matrices throughout; emits "
                        "scale_curve.csv + scale_curve.html)")
    p.add_argument("--scale-points", default="256,1024,4096,16384",
                   dest="scale_points",
                   help="comma list of fleet device counts for --scale-curve")
    p.add_argument("--jobs", "-j", default="1",
                   help="evaluate (config, mesh) cells on N worker threads "
                        "('-j auto' = one per CPU).  Output is identical "
                        "to the default serial run (-j 1): results are "
                        "assembled in deterministic order")
    p.add_argument("--formats", default="json,csv,html,perfetto")
    p.add_argument("--out", default=os.path.join("artifacts", "sweep"))
    _add_device_opt(p)
    _add_cache_opts(p)
    p.set_defaults(func=_cmd_sweep)

    p = sub.add_parser("lint", help="static anti-pattern analysis with "
                                    "modeled savings (CI exit codes)")
    p.add_argument("target",
                   help="a sweep-config name or a saved report .json "
                        "(CommReport.save / cache entry / sweep document)")
    p.add_argument("--mesh", default="4x2",
                   help="mesh spec for config targets, e.g. 8, 4x2, 2x2x2")
    p.add_argument("--algorithms", default="",
                   help="comma list of ring,tree,hierarchical; default: "
                        "the report's own binding (ring for configs)")
    p.add_argument("--fail-on", choices=["warn", "error"], default=None,
                   dest="fail_on",
                   help="exit 1 when any finding is at or above this "
                        "severity (default: always exit 0 when the "
                        "analysis ran)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable findings JSON on stdout")
    _add_device_opt(p)
    _add_cache_opts(p)
    p.set_defaults(func=_cmd_lint)

    p = sub.add_parser("compare",
                       help="import a device trace and compare measured "
                            "vs modeled per-collective seconds")
    p.add_argument("trace",
                   help="a trace file: torch.profiler or Perfetto/Chrome "
                        "JSON (our own export too), nvprof/ComScribe CSV, "
                        "or the generic JSONL schema")
    p.add_argument("model", nargs="?", default="",
                   help="the modeled side: a sweep-config name or a saved "
                        "report .json (default: the imported trace's own "
                        "model, which needs a topology -- true for our "
                        "own Perfetto exports)")
    p.add_argument("--fmt", default="",
                   help="force a trace frontend: torch, perfetto, nvprof, "
                        "jsonl (default: sniff the file)")
    p.add_argument("--trace-devices", type=int, default=None,
                   dest="trace_devices",
                   help="device count of the traced job (default: from "
                        "the trace; device ids are validated against it)")
    p.add_argument("--mesh", default="4x2",
                   help="mesh spec for config models, e.g. 8, 4x2, 2x2x2")
    p.add_argument("--algorithms", default="",
                   help="comma list of ring,tree,hierarchical; default: "
                        "the model's own binding")
    p.add_argument("--fail-on", default=None, dest="fail_on",
                   metavar="rel-err=X",
                   help="exit 1 when the max relative error exceeds X "
                        "(e.g. rel-err=0.25)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable comparison JSON on stdout "
                        "(sweep logs go to stderr)")
    p.add_argument("--formats", default="",
                   help="also export: comma list of csv,html")
    p.add_argument("--out", default="artifacts")
    p.add_argument("--save-import", default="", dest="save_import",
                   help="also save the imported trace as a schema-v9 "
                        "report JSON at this path")
    _add_device_opt(p)
    _add_cache_opts(p)
    p.set_defaults(func=_cmd_compare)

    p = sub.add_parser("report", help="re-export a saved report")
    p.add_argument("path", help="a CommReport.save JSON file")
    p.add_argument("--formats", default="html")
    p.add_argument("--out", default="artifacts")
    p.add_argument("--render", action="store_true",
                   help="also print the terminal rendering")
    p.set_defaults(func=_cmd_report)

    p = sub.add_parser("configs", help="list sweepable configs")
    p.set_defaults(func=_cmd_configs)

    p = sub.add_parser("cache", help="inspect / clear the report cache")
    p.add_argument("--clear", action="store_true")
    _add_cache_opts(p)
    p.set_defaults(func=_cmd_cache)

    p = sub.add_parser("dryrun", add_help=False,
                       help="production-mesh dry run (all arguments "
                            "forwarded to repro_torch.launch.dryrun)")
    p.set_defaults(func=_cmd_dryrun, rest=[])
    return ap


def main(argv=None) -> int:
    parser = build_parser()
    # dryrun forwards everything (its --flags too) to
    # repro_torch.launch.dryrun's own parser
    args, extra = parser.parse_known_args(argv)
    if args.func is _cmd_dryrun:
        args.rest = extra
    elif args.func is _cmd_monitor and args.target.endswith(".py"):
        args.script_args = extra     # forwarded to the script's own argv
    elif extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    try:
        return args.func(args) or 0
    except (ValueError, FileNotFoundError) as e:
        # spec / format / path errors are user errors, not crashes
        # (anything else -- including KeyError -- keeps its traceback)
        msg = e.args[0] if isinstance(e, ValueError) and e.args else e
        print(f"error: {msg}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
