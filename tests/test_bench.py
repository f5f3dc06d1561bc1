import json

from grayscott_tpu.bench.harness import (
    Result,
    default_domains,
    default_step_counts,
    run_one,
    sweep,
)
from grayscott_tpu.backends import get_backend
from grayscott_tpu.params import Parameters


def test_default_sweep_grid_matches_reference():
    # domains [2^s, 2^{s+1}] s=3..11 and steps 2^0..2^8
    # (compute/shared/src/benchmark.rs:50-56)
    doms = default_domains()
    assert doms[0] == (8, 16) and doms[-1] == (2048, 4096)
    steps = default_step_counts()
    assert steps[0] == 1 and steps[-1] == 256 and len(steps) == 9


def test_run_one_workloads(tmp_path):
    sim = get_backend("fused")(Parameters())
    for workload in ("compute", "full_sync", "full_future"):
        res = run_one(sim, (16, 32), 4, workload, reps=1)
        assert res.gcells_per_sec > 0
        assert res.shape == (16, 32)


def test_sweep_writes_json(tmp_path):
    out = tmp_path / "r.json"
    results = sweep(
        ["fused"], domains=[(8, 16)], step_counts=[2],
        workloads=("compute",), reps=1, out_path=str(out), verbose=False,
    )
    assert len(results) == 1
    data = json.loads(out.read_text())
    assert data[0]["backend"] == "fused"


def test_report_markdown_with_baseline(tmp_path):
    """Sweep JSON -> markdown table with per-row baseline deltas, new and
    gone rows handled (criterion-report analog, reference README:153-173)."""
    import json

    from grayscott_tpu.bench import report

    cur = [
        {"backend": "sharded", "workload": "compute", "shape": [64, 128],
         "steps": 32, "boundary": "zero", "gcells_per_sec": 50.0},
        {"backend": "sharded", "workload": "compute", "shape": [128, 256],
         "steps": 32, "boundary": "zero", "gcells_per_sec": 60.0},
    ]
    base = [
        {"backend": "sharded", "workload": "compute", "shape": [64, 128],
         "steps": 32, "boundary": "zero", "gcells_per_sec": 40.0},
        {"backend": "fused", "workload": "compute", "shape": [64, 128],
         "steps": 32, "boundary": "zero", "gcells_per_sec": 10.0},
    ]
    cur_p, base_p = tmp_path / "cur.json", tmp_path / "base.json"
    cur_p.write_text(json.dumps(cur))
    base_p.write_text(json.dumps(base))
    md = report.report(str(cur_p), str(base_p))
    assert "+25.0%" in md          # 40 -> 50
    assert "new" in md             # 128x256 has no baseline
    assert "was 10.00" in md       # fused row disappeared
    assert "64x128" in md
    html = report.report(str(cur_p), str(base_p), fmt="html")
    assert html.startswith("<!doctype html>") and "+25.0%" in html


def test_report_cli(tmp_path, capsys):
    """--report renders without touching any device."""
    import json

    from grayscott_tpu.bench import harness

    p = tmp_path / "s.json"
    p.write_text(json.dumps([
        {"backend": "fused", "workload": "compute", "shape": [8, 16],
         "steps": 4, "boundary": "naive", "gcells_per_sec": 1.25},
    ]))
    assert harness.main(["--report", str(p)]) == 0
    out = capsys.readouterr().out
    assert "| fused |" in out and "1.25" in out


def _load_bench():
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "bench_headline",
        pathlib.Path(__file__).resolve().parent.parent / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_headline_json_contract(monkeypatch, capsys):
    """bench.py emits ONE JSON line whose per-methodology keys never
    conflate definitions: value == value_steady_state, value_single_run
    is separate, the naive-boundary second row rides along, and the
    device and card it ran on are named; vs_baseline divides by the
    card's roofline from the peak table."""
    from grayscott_tpu.bench import roofline

    mod = _load_bench()

    def fake_measure(r=4096, c=4096, steps=1000, boundary="zero"):
        steady = 80.0 if boundary == "naive" else 90.0
        return "fused", steady, steady - 10.0, 5

    monkeypatch.setattr(mod, "measure", fake_measure)
    # the CPU test platform stands in for a card with the H100's peak
    monkeypatch.setitem(roofline.HBM_BYTES_PER_S, "cpu", 3.35e12)
    monkeypatch.setattr(roofline, "card_line",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    assert mod.main() == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1  # ONE JSON line on stdout
    rec = json.loads(out[0])
    assert rec["value"] == rec["value_steady_state"] == 90.0
    assert rec["value_single_run"] == 80.0
    assert rec["naive_steady_state"] == 80.0
    assert rec["naive_single_run"] == 70.0
    assert rec["unit"] == "Gcell/s"
    assert rec["vs_baseline"] == 90.0 / 209.375
    assert 0 < rec["naive_vs_baseline"] < rec["vs_baseline"]
    assert rec["device"]["platform"] == "cpu"
    assert rec["card"] == "NVIDIA H100 80GB HBM3, 700.00 W"


def test_bench_refuses_device_without_published_peak():
    """On a device missing from the peak table bench.py raises before it
    measures anything: no rate is ever divided by a guessed peak."""
    import pytest

    mod = _load_bench()
    with pytest.raises(ValueError, match="no published memory bandwidth"):
        mod.main()


def test_sweep_backend_kwargs_plumbed():
    """backend_kwargs reach the backend and label every result."""
    results = sweep(
        ["sharded"], domains=[(16, 16)], step_counts=[3],
        workloads=("compute",), reps=1, verbose=False,
        backend_kwargs={"steps_per_exchange": 2, "n_devices": 2},
    )
    assert len(results) == 1
    assert results[0].extra["steps_per_exchange"] == 2
    assert results[0].gcells_per_sec > 0
