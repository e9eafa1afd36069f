"""Port parity: the counted rows of ``BENCH_collective_bytes.json``.

``repro_torch.analysis.counted_rows`` runs the port (gloo ranks on the CPU,
one spawn per mesh width) on the JAX benchmark's numpy-seeded inputs;
every counter row of the committed file is one case here, equal field by
field except the ``DIVERGENT`` fields, whose reason is checked against
the JAX program itself. The summary's counted fields are equal; a +1
planted in a copy of the file is reported with both values; timing rows
are never produced or compared.
"""

import copy
import json
import os
import subprocess
import sys
from collections import Counter

import pytest
import torch

from repro_torch.analysis import counted_rows as CR

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = CR.committed()
COUNTER_ROWS = [r for r in COMMITTED["rows"]
                if r["mode"] not in CR.TIMING_MODES]
FOLDED_BYTES = 8 * (32 + 320) * 4     # the separate form's two id gathers


@pytest.fixture(scope="module")
def fresh():
    return CR.counted_rows(device="cpu")


def test_the_committed_file_holds_37_counter_rows():
    assert Counter(r["mode"] for r in COUNTER_ROWS) == {
        "sampled": 10, "wire": 6, "skip_rate": 4, "coalesce": 4, "full": 3,
        "sparse": 3, "partition": 2, "coalesce_grad": 2, "serving": 2,
        "serving_cache": 1}


def test_the_port_produces_exactly_the_counter_rows(fresh):
    assert sorted(CR.row_key(r) for r in fresh["rows"]) == sorted(
        CR.row_key(r) for r in COUNTER_ROWS)
    assert not any(r["mode"] in CR.TIMING_MODES for r in fresh["rows"])
    assert not any(set(r) & CR.TIMING_FIELDS for r in fresh["rows"])


@pytest.mark.parametrize("want", COUNTER_ROWS,
                         ids=lambda r: CR.fmt_key(CR.row_key(r)))
def test_row_equals_the_committed_row(fresh, want):
    key = CR.row_key(want)
    got = next(r for r in fresh["rows"] if CR.row_key(r) == key)
    assert set(got) == set(want)
    for field in sorted(set(want) - CR.ID_FIELDS):
        if (key, field) in CR.DIVERGENT:
            assert got[field] == want[field] + FOLDED_BYTES, field
        else:
            assert got[field] == want[field], field


def test_summary_counted_fields_equal(fresh):
    s, c = fresh["summary"], COMMITTED["summary"]
    for key in CR.COUNTED_SUMMARY:
        assert s[key] == c[key], key
    assert s["paper_figure_ratio"] >= CR.PAPER_MIN_RATIO
    assert round(s["paper_figure_ratio"], 2) == 36.10
    assert round(s["max_ratio"], 2) == 42.86
    assert s["partition_remote_rows"] == {"interval": 4449, "island": 432}
    assert s["clustered_skipped_rounds"] == 900
    assert s["serving_cache_hit_rate"] == 0.75
    assert (s["checked"], s["failed"]) == (c["checked"], c["failed"])
    assert not {"agg_pallas_sched_vs_xla",
                "agg_sched_vs_unsched_pallas"} & set(s)


def test_no_drift_against_the_committed_file(fresh):
    drift, divergent = CR.compare(fresh, COMMITTED)
    assert drift == []
    assert sorted((w, f) for w, f, _, _ in divergent) == sorted(
        (CR.fmt_key(k), f) for k, f in CR.DIVERGENT)


def test_divergent_table_keys_are_pinned():
    assert set(CR.DIVERGENT) == {
        ((("F", 64), ("flow", flow), ("form", "separate"),
          ("mode", "coalesce"), ("ways", 8)), "bytes")
        for flow in ("baseline", "cgtrans")}


_FOLD_PROBE = r"""
import json
import jax, jax.numpy as jnp
from repro.core import cgtrans
from repro.launch.mesh import make_data_mesh
from repro.launch import hlo_analysis as H
mesh = make_data_mesh(8)
R1, K2, F, part = 32, 10, 64, 32
feats = jnp.zeros((8, part, F))
b1 = (jnp.zeros((8, R1, 1), jnp.int32), jnp.ones((8, R1, 1), bool))
b2 = (jnp.zeros((8, R1, K2), jnp.int32), jnp.ones((8, R1, K2), bool))
out = {}
for flow in ("baseline", "cgtrans"):
    def sep(f, n1, m1, n2, m2):
        return (cgtrans.aggregate_sampled(f, n1, m1, mesh=mesh, dataflow=flow),
                cgtrans.aggregate_sampled(f, n2, m2, mesh=mesh, dataflow=flow))
    txt = jax.jit(sep).lower(feats, *b1, *b2).compile().as_text()
    out[flow] = H.analyze(txt).collective_bytes
print(json.dumps(out))
"""


def test_divergent_fields_are_the_folded_request_gathers(fresh):
    """The reason ``DIVERGENT`` gives, held against the JAX program: with
    the requests passed as arguments (not closed over as constants) the
    separate form's compiled HLO holds the port's bytes."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _FOLD_PROBE],
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    jax_bytes = json.loads(proc.stdout.strip().splitlines()[-1])
    for flow in ("baseline", "cgtrans"):
        got = next(r for r in fresh["rows"] if r["mode"] == "coalesce"
                   and r["flow"] == flow and r["form"] == "separate")
        assert got["bytes"] == jax_bytes[flow]


def _planted(tmp_path, row_pred, field, delta=1):
    planted = copy.deepcopy(COMMITTED)
    row = next(r for r in planted["rows"] if row_pred(r))
    row[field] += delta
    path = tmp_path / "planted.json"
    path.write_text(json.dumps(planted))
    return path, row


def test_planted_drift_is_reported_with_both_values(fresh, tmp_path,
                                                    monkeypatch, capsys):
    path, row = _planted(tmp_path, lambda r: r.get("paper_figure"),
                         "cgtrans")
    drift, _ = CR.compare(fresh, CR.committed(path))
    assert drift == [(CR.fmt_key(CR.row_key(row)), "cgtrans",
                      row["cgtrans"], row["cgtrans"] - 1)]
    # the CLI: exit 1, the field named with both values
    monkeypatch.setattr(CR, "counted_rows", lambda device: fresh)
    out = tmp_path / "rows.json"
    assert CR.main(["--device", "cpu", "--committed", str(path),
                    "--out", str(out)]) == 1
    err = capsys.readouterr().err
    assert f"cgtrans: committed {row['cgtrans']}, port " \
           f"{row['cgtrans'] - 1}" in err
    assert json.loads(out.read_text()) == fresh


def test_cli_exits_0_without_drift(fresh, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(CR, "counted_rows", lambda device: fresh)
    assert CR.main(["--device", "cpu", "--out",
                    str(tmp_path / "rows.json")]) == 0
    out = capsys.readouterr().out
    assert "baseline 6617600 B, cgtrans 183296 B, ratio 36.10" in out
    assert "no drift" in out


def test_timing_rows_are_never_compared(fresh, tmp_path):
    planted = copy.deepcopy(COMMITTED)
    for r in planted["rows"]:
        if r["mode"] in CR.TIMING_MODES:
            r["us"] = r["us"] * 2 + 1
    planted["summary"]["agg_pallas_sched_vs_xla"] = 123.0
    drift, _ = CR.compare(fresh, planted)
    assert drift == []


def test_a_stale_divergent_entry_is_drift(fresh):
    healed = copy.deepcopy(fresh)
    for r in healed["rows"]:
        if r["mode"] == "coalesce" and r["form"] == "separate":
            r["bytes"] -= FOLDED_BYTES
    drift, divergent = CR.compare(healed, COMMITTED)
    assert divergent == [] and len(drift) == 2


def test_a_missing_row_is_drift(fresh):
    short = dict(fresh, rows=[r for r in fresh["rows"]
                              if r["mode"] != "serving_cache"])
    drift, _ = CR.compare(short, COMMITTED)
    cache = next(r for r in COUNTER_ROWS if r["mode"] == "serving_cache")
    assert drift == [(CR.fmt_key(CR.row_key(cache)), "<row>", "present",
                      "missing")]


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CR.counted_rows()
