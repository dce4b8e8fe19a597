"""The port's bench-regression gate against the JAX package's.

``repro_torch.obs.regress`` keeps its own copy of ``repro.obs.regress``:
the same tolerance table, the same failures for the same rows, the same
printed lines, report and exit codes. Each case feeds both packages the
same inputs and holds the results equal (exactly: the gate is host-side
JSON arithmetic, no tolerance of its own is involved).

* ``field_tolerance`` over names that reach every line of the table.
* ``compare_rows`` over clean rows and each kind of drift: modeled
  values, losses within and past 2%, schedule counts within and past 35%,
  a flipped boolean, lists one longer or changed, a type change, NaN
  against NaN, a missing row and an extra fresh row.
* A property: random flat and nested rows, perturbed at random, give the
  same failures from both packages.
* The CLI in a temporary directory: clean, injected, ``--allow-missing``,
  ``--files`` and no baselines, in process and once as ``python -m``.
* Importing the port's module loads neither JAX nor the JAX package.
"""
import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
from hypothesis import given, settings, strategies as st

from repro.obs import regress as ref
from repro_torch.obs import regress as port
from repro_torch import obs as port_obs

SRC = Path(__file__).resolve().parents[1] / "src"

FIELDS = ["us_per_call", "wall.ms_per_step", "pad_elems_per_step",
          "per_leaf.collectives", "final_ppl", "n_spans", "ratio", "gate",
          "sync_steps", "final_loss", "loss_delta_pct", "sync_count",
          "comm_reduction", "mb_per_step", "n_events", "sync_gap_min",
          "sync_gap_max", "step_s", "encode_ms", "comm_us", "speedup",
          "tokens_throughput", "epoch_hours", "elapsed", "comm_fraction",
          "trace", "chrome", "note", "launches", "wire_bytes",
          "a.b.c.collectives", "walls_s.x", "ratio_x"]


@pytest.mark.parametrize("field", FIELDS)
def test_field_tolerance_equal(field):
    assert port.field_tolerance(field) == ref.field_tolerance(field)


def test_tolerance_table_same_labels_and_order():
    assert [(label, tol) for label, _, tol in port.TOLERANCES] == [
        (label, tol) for label, _, tol in ref.TOLERANCES]
    assert port.IDENTITY_KEYS == ref.IDENTITY_KEYS
    assert port_obs.TOLERANCES is port.TOLERANCES
    assert port_obs.compare_rows is port.compare_rows
    assert port_obs.compare_files is port.compare_files


BASE = [{"bench": "sync", "mode": "flat", "workers": 2, "launches": 8,
         "wire_bytes": 1690757120, "final_loss": 6.5, "sync_count": 10,
         "ok": True, "per_step": [1, 2, 3], "names": ["a", "b"],
         "step_ms": 101.1, "walls": {"local_ms": 95.3, "collectives": 22},
         "sync_steps": [3, 7], "note": "x"},
        {"bench": "sync", "mode": "per_leaf", "workers": 2, "launches": 88,
         "ppl": float("nan"), "gate": True}]


def _with(i, key, value):
    rows = copy.deepcopy(BASE)
    if "." in key:
        outer, inner = key.split(".")
        rows[i][outer][inner] = value
    else:
        rows[i][key] = value
    return rows


CASES = {
    "clean": (BASE, copy.deepcopy(BASE)),
    "modeled_drift": (BASE, _with(0, "wire_bytes", 1690757121 * 1.001)),
    "modeled_nested_drift": (BASE, _with(0, "walls.collectives", 23)),
    "loss_plus_1_5pct": (BASE, _with(0, "final_loss", 6.5 * 1.015)),
    "loss_minus_1_5pct": (BASE, _with(0, "final_loss", 6.5 * 0.985)),
    "loss_plus_10pct": (BASE, _with(0, "final_loss", 6.5 * 1.10)),
    "schedule_plus_20pct": (BASE, _with(0, "sync_count", 12)),
    "schedule_plus_100pct": (BASE, _with(0, "sync_count", 20)),
    "boolean_flipped": (BASE, _with(0, "ok", False)),
    "list_one_longer": (BASE, _with(0, "per_step", [1, 2, 3, 4])),
    "list_changed": (BASE, _with(0, "per_step", [1, 2, 4])),
    "type_change": (BASE, _with(0, "launches", "8")),
    "nan_vs_nan": (BASE, copy.deepcopy(BASE)),
    "nan_vs_number": (BASE, _with(1, "ppl", 3.0)),
    "walls_doubled": (BASE, _with(0, "step_ms", 202.2)),
    "skipped_fields_changed": (BASE, _with(0, "sync_steps", [1])),
    "missing_row": (BASE, copy.deepcopy(BASE[:1])),
    "missing_field": (BASE, [{k: v for k, v in BASE[0].items()
                              if k != "launches"}, BASE[1]]),
    "extra_fresh_row": (BASE, copy.deepcopy(BASE) + [
        {"bench": "new", "launches": 1}]),
    "no_identity": ([{"x": 1}], [{"x": 2}]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compare_rows_equal(case):
    base, fresh = CASES[case]
    got = port.compare_rows(base, fresh, file="BENCH_t.json")
    want = ref.compare_rows(base, fresh, file="BENCH_t.json")
    assert got == want
    clean = case in ("clean", "nan_vs_nan", "loss_plus_1_5pct",
                     "loss_minus_1_5pct", "schedule_plus_20pct",
                     "walls_doubled", "skipped_fields_changed",
                     "extra_fresh_row")
    assert (got == []) == clean, got


names = st.sampled_from(["launches", "final_loss", "step_ms", "sync_count",
                         "ok", "per_step", "gate", "note", "wire_bytes",
                         "n_spans", "ratio"])
scalars = st.one_of(st.integers(-10**6, 10**6), st.booleans(),
                    st.floats(allow_nan=True, allow_infinity=False,
                              width=32), st.text(max_size=3),
                    st.lists(st.integers(-5, 5), max_size=3))
values = st.recursive(scalars, lambda inner: st.dictionaries(
    names, inner, max_size=3), max_leaves=6)
rows = st.lists(st.fixed_dictionaries(
    {"bench": st.sampled_from(["a", "b", "c"])},
    optional={"mode": st.sampled_from(["flat", "per_leaf"]),
              "workers": st.integers(1, 4)}).flatmap(
    lambda ident: st.dictionaries(names, values, max_size=4).map(
        lambda body: {**body, **ident})), max_size=4)


@settings(max_examples=200, deadline=None)
@given(base=rows, fresh=rows, data=st.data())
def test_compare_rows_property(base, fresh, data):
    # half the time the fresh rows are the baseline's, perturbed
    if data.draw(st.booleans()):
        fresh = copy.deepcopy(base)
        for row in fresh:
            for k in list(row):
                if k not in port.IDENTITY_KEYS and data.draw(st.booleans()):
                    row[k] = data.draw(values)
    assert port.compare_rows(base, fresh, "f") == ref.compare_rows(
        base, fresh, "f")


def _write(directory: Path, name: str, rows) -> None:
    directory.mkdir(parents=True, exist_ok=True)
    (directory / name).write_text(json.dumps(rows))


def _cli_dirs(tmp_path: Path, case: str):
    base, fresh = tmp_path / "base", tmp_path / "fresh"
    base.mkdir()
    fresh.mkdir()
    if case == "no_baselines":
        return base, fresh, []
    _write(base, "BENCH_a.json", BASE)
    _write(base, "BENCH_b.json", BASE[:1])
    _write(fresh, "BENCH_a.json", BASE)
    if case == "clean":
        _write(fresh, "BENCH_b.json", BASE[:1])
        return base, fresh, []
    if case == "injected":
        _write(fresh, "BENCH_b.json", _with(0, "launches", 9)[:1])
        return base, fresh, []
    if case == "allow_missing":
        return base, fresh, ["--allow-missing"]
    if case == "missing":
        return base, fresh, []
    if case == "files":
        _write(fresh, "BENCH_b.json", _with(0, "launches", 9)[:1])
        return base, fresh, ["--files", "BENCH_a.json"]
    if case == "not_a_list":
        (fresh / "BENCH_b.json").write_text(json.dumps({"x": 1}))
        return base, fresh, []
    raise KeyError(case)


def _run_main(main, argv, capsys):
    try:
        main(argv)
        code = 0
    except SystemExit as e:
        code = e.code
    return code, capsys.readouterr().out


CLI_CASES = ["clean", "injected", "allow_missing", "missing", "files",
             "not_a_list", "no_baselines"]
CLI_CODES = {"clean": 0, "injected": 1, "allow_missing": 0, "missing": 1,
             "files": 0, "not_a_list": 1}


@pytest.mark.parametrize("case", CLI_CASES)
def test_cli_equal(case, tmp_path, capsys):
    base, fresh, extra = _cli_dirs(tmp_path, case)
    out = {}
    for tag, mod in (("port", port), ("ref", ref)):
        report = tmp_path / f"report_{tag}.json"
        argv = ["--baselines", str(base), "--fresh", str(fresh),
                "--report", str(report), *extra]
        code, stdout = _run_main(mod.main, argv, capsys)
        out[tag] = (code, stdout, report.read_text() if report.exists()
                    else None)
    assert out["port"] == out["ref"]
    code = out["port"][0]
    if case == "no_baselines":
        assert code == f"no baselines found under {base}"
    else:
        assert code == CLI_CODES[case]
        assert json.loads(out["port"][2])["checked_files"] == (
            1 if case in ("allow_missing", "files") else 2)


def test_cli_baselines_required(capsys):
    with pytest.raises(SystemExit) as e:
        port.main(["--fresh", "."])
    assert e.value.code == 2
    assert "--baselines" in capsys.readouterr().err


@pytest.mark.parametrize("case", ["clean", "injected"])
def test_cli_module_run_equal(case, tmp_path):
    base, fresh, extra = _cli_dirs(tmp_path, case)
    env = {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu"}
    out = {}
    for tag, mod in (("port", "repro_torch.obs.regress"),
                     ("ref", "repro.obs.regress")):
        report = tmp_path / f"report_{tag}.json"
        p = subprocess.run([sys.executable, "-m", mod, "--baselines",
                            str(base), "--fresh", str(fresh), "--report",
                            str(report), *extra], capture_output=True,
                           text=True, env=env, timeout=300)
        out[tag] = (p.returncode, p.stdout, report.read_text())
    assert out["port"] == out["ref"]
    assert out["port"][0] == CLI_CODES[case]


def test_import_loads_neither_jax_nor_reference():
    code = ("import sys, repro_torch.obs.regress, repro_torch.obs; "
            "print([m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')])")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(SRC)})
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"
