"""Bench-regression gate: fresh ``BENCH_*.json`` rows against baselines.

The port's copy of the JAX package's ``obs/regress.py`` (framework-free),
with the same table, the same failures, the same printed lines and report,
so either package's gate reads the other's rows the same way.

A benchmark's rows carry two kinds of numbers: *modeled / structural*
facts (kernel-launch counts, collective counts, modeled wire and memory
bytes, padding counts, gate booleans) that must reproduce exactly on any
machine, and *measured* walls (``*_ms``, ``*_s``, ``us_per_call``, ...)
that do not. The gate diffs a fresh JSON against a baseline row by row and
field by field with the tolerances stated in :data:`TOLERANCES` (first
match wins on a field's last dotted part), and exits 1 on any regression:

  skipped      walls and derived fractions (``*_s``, ``*_ms``, ``*_us``,
               ``ms_per*``, ``us_per*``, walls, speedups, ratios, comm
               fractions, throughputs), paths, notes, ``gate`` and the
               adaptive schedules' raw ``sync_steps`` lists;
  loss-like    ``*loss*`` / ``*ppl*``: relative 2%;
  schedule     ``sync_count`` and friends, span and event counts:
               relative 35%;
  default      every other number is modeled and must hold to relative
               1e-6; booleans must match exactly.

Rows are matched by their identity keys (:data:`IDENTITY_KEYS`, those a
row has); a baseline row with no fresh counterpart is a regression (a
benchmark dropped coverage), an extra fresh row is not.

  PYTHONPATH=src python -m repro_torch.obs.regress --baselines DIR \
      [--fresh .] [--files BENCH_x.json ...] [--report out.json] \
      [--allow-missing]

``--baselines`` has no default: the JAX package's default directory holds
its own benchmarks' rows, which the port's runs are not held to.
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["compare_rows", "compare_files", "main", "TOLERANCES"]

#: row keys that identify a row (the subset a row has).
IDENTITY_KEYS = ("bench", "method", "mode", "policy", "codec", "variant",
                 "workers", "mesh", "H")

#: (label, matcher, relative tolerance | None = skip): first match wins.
TOLERANCES: List[Tuple[str, Any, Optional[float]]] = [
    ("timing/derived (machine-dependent): skipped",
     lambda f: (f.endswith("_s") or f.endswith("_ms") or f.endswith("_us")
                or f.startswith("ms_per") or f.startswith("us_per")
                or "wall" in f or "speedup" in f or "throughput" in f
                or "epoch_hours" in f or "elapsed" in f
                or "comm_fraction" in f or f == "ratio"
                or "comm_us" in f),
     None),
    ("paths/notes/schedules: skipped",
     lambda f: f in ("trace", "chrome", "note", "sync_steps", "gate"),
     None),
    ("loss-like: 2% relative",
     lambda f: ("loss" in f or "ppl" in f), 0.02),
    ("schedule-dependent counts: 35% relative",
     lambda f: ("sync_count" in f or "sync_reduction" in f
                or "comm_reduction" in f or "mb_per_step" in f
                or f in ("n_spans", "n_events", "sync_gap_min",
                         "sync_gap_max")),
     0.35),
    ("modeled/structural: 1e-6 relative", lambda f: True, 1e-6),
]


def field_tolerance(field: str) -> Optional[float]:
    """The relative tolerance :data:`TOLERANCES` gives ``field`` (by its
    last dotted part; None: not compared)."""
    leaf = field.rsplit(".", 1)[-1]
    for _, match, tol in TOLERANCES:
        if match(leaf):
            return tol
    return None


def _identity(row: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    out = []
    for k in IDENTITY_KEYS:
        if k in row:
            v = row[k]
            out.append((k, json.dumps(v) if isinstance(v, (list, dict))
                        else str(v)))
    return tuple(out)


def _flatten(prefix: str, value: Any, out: Dict[str, Any]) -> None:
    if isinstance(value, dict):
        for k, v in value.items():
            _flatten(f"{prefix}.{k}" if prefix else str(k), v, out)
    else:
        out[prefix] = value


def _num_close(a: float, b: float, tol: float) -> bool:
    if math.isnan(a) and math.isnan(b):
        return True
    scale = max(abs(a), abs(b), 1e-12)
    return abs(a - b) <= tol * scale + 1e-12


def _compare_value(field: str, base: Any, fresh: Any,
                   tol: float) -> Optional[str]:
    """None when ``fresh`` holds ``base`` to ``tol``, else the reason."""
    if isinstance(base, bool) or isinstance(fresh, bool):
        if bool(base) != bool(fresh):
            return f"{field}: {base!r} -> {fresh!r} (boolean gate flipped)"
        return None
    if isinstance(base, (int, float)) and isinstance(fresh, (int, float)):
        if not _num_close(float(base), float(fresh), tol):
            return (f"{field}: {base!r} -> {fresh!r} "
                    f"(> {tol:g} relative tolerance)")
        return None
    if isinstance(base, list) and isinstance(fresh, list):
        if not all(isinstance(v, (int, float, bool)) for v in base):
            return None                      # a non-numeric list: skipped
        if len(base) != len(fresh):
            return (f"{field}: length {len(base)} -> {len(fresh)}")
        for i, (a, b) in enumerate(zip(base, fresh)):
            r = _compare_value(f"{field}[{i}]", a, b, tol)
            if r:
                return r
        return None
    if isinstance(base, str):
        return None                          # strings count as identity only
    if type(base) is not type(fresh):
        return f"{field}: type {type(base).__name__} -> {type(fresh).__name__}"
    return None


def compare_rows(baseline: Sequence[Dict[str, Any]],
                 fresh: Sequence[Dict[str, Any]],
                 file: str = "") -> List[Dict[str, Any]]:
    """Every regression of ``fresh`` against ``baseline`` (empty: clean),
    each a dict of ``file``, ``row`` (its identity) and ``reason``."""
    fresh_by_id: Dict[Tuple, Dict[str, Any]] = {}
    for row in fresh:
        fresh_by_id.setdefault(_identity(row), row)
    failures: List[Dict[str, Any]] = []
    for row in baseline:
        ident = _identity(row)
        tag = ", ".join(f"{k}={v}" for k, v in ident) or "<no identity>"
        match = fresh_by_id.get(ident)
        if match is None:
            failures.append({"file": file, "row": tag,
                             "reason": "baseline row missing from fresh "
                                       "output (bench dropped coverage?)"})
            continue
        flat_b: Dict[str, Any] = {}
        flat_f: Dict[str, Any] = {}
        _flatten("", dict(row), flat_b)
        _flatten("", dict(match), flat_f)
        for fieldname, base_v in flat_b.items():
            tol = field_tolerance(fieldname)
            if tol is None or fieldname in dict(ident):
                continue
            if fieldname not in flat_f:
                failures.append({"file": file, "row": tag,
                                 "reason": f"{fieldname}: missing from "
                                           f"fresh row"})
                continue
            reason = _compare_value(fieldname, base_v, flat_f[fieldname], tol)
            if reason:
                failures.append({"file": file, "row": tag, "reason": reason})
    return failures


def compare_files(baseline_path: str, fresh_path: str) -> List[Dict[str, Any]]:
    """:func:`compare_rows` of two JSON files of rows (a missing fresh file
    or one that is not a list of rows is one failure)."""
    name = os.path.basename(baseline_path)
    if not os.path.exists(fresh_path):
        return [{"file": name, "row": "", "reason":
                 f"fresh bench output {fresh_path} not found"}]
    with open(baseline_path) as f:
        baseline = json.load(f)
    with open(fresh_path) as f:
        fresh = json.load(f)
    if not isinstance(baseline, list) or not isinstance(fresh, list):
        return [{"file": name, "row": "", "reason":
                 "bench JSON must be a list of row dicts"}]
    return compare_rows(baseline, fresh, file=name)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--baselines", required=True,
                    help="directory of the baseline BENCH_*.json files")
    ap.add_argument("--fresh", default=".",
                    help="directory holding the freshly produced BENCH_*.json")
    ap.add_argument("--files", nargs="*", default=None,
                    help="restrict to these basenames (default: every "
                         "baseline present)")
    ap.add_argument("--report", default="",
                    help="write the failure report JSON here")
    ap.add_argument("--allow-missing", action="store_true",
                    help="a missing fresh file is a warning, not a failure "
                         "(for partial local runs)")
    args = ap.parse_args(argv)

    paths = sorted(glob.glob(os.path.join(args.baselines, "BENCH_*.json")))
    if args.files:
        keep = set(args.files)
        paths = [p for p in paths if os.path.basename(p) in keep]
    if not paths:
        raise SystemExit(f"no baselines found under {args.baselines}")

    all_failures: List[Dict[str, Any]] = []
    checked = 0
    for bpath in paths:
        name = os.path.basename(bpath)
        fpath = os.path.join(args.fresh, name)
        if args.allow_missing and not os.path.exists(fpath):
            print(f"[regress] {name}: fresh output missing, skipped")
            continue
        fails = compare_files(bpath, fpath)
        checked += 1
        if fails:
            print(f"[regress] {name}: {len(fails)} regression(s)")
            for f in fails:
                print(f"  - {f['row']}: {f['reason']}" if f["row"]
                      else f"  - {f['reason']}")
        else:
            print(f"[regress] {name}: ok")
        all_failures.extend(fails)

    if args.report:
        with open(args.report, "w") as f:
            json.dump({"checked_files": checked,
                       "failures": all_failures}, f, indent=1)
    if all_failures:
        print(f"BENCH REGRESSION GATE FAILED: {len(all_failures)} "
              f"regression(s) across {checked} file(s)")
        raise SystemExit(1)
    print(f"bench regression gate: {checked} file(s) clean")


if __name__ == "__main__":
    main()
