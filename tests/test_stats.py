"""Criterion-grade statistics (bench/stats.py) and their consumers:
dispersion in reports, the CI-overlap regression gate, and the
adopt-sweep noise band. The reference's harness never trusts a point
estimate (compute/shared/src/benchmark.rs:50-72); neither do we now.
"""

from __future__ import annotations

import json

import pytest

from grayscott_tpu.bench import report, stats


def test_summarize_basics():
    s = stats.summarize([10.0, 10.2, 9.9, 10.1, 10.05])
    assert s["n"] == 5
    assert s["median"] == pytest.approx(10.05)
    assert s["mad"] == pytest.approx(0.1, abs=0.06)
    assert s["ci95"][0] < s["median"] < s["ci95"][1]
    assert s["outliers_mild"] == 0 and s["outliers_severe"] == 0


def test_summarize_flags_outliers():
    # one sample 3x the rest: a severe Tukey outlier (criterion's fences)
    s = stats.summarize([10.0, 10.2, 9.9, 10.1, 30.0])
    assert s["outliers_severe"] == 1
    # the median is untouched by the contamination
    assert s["median"] == pytest.approx(10.1)


def test_summarize_single_sample():
    s = stats.summarize([5.0])
    assert s["median"] == 5.0 and s["mad"] == 0.0
    # never a zero-width CI: one sample cannot claim perfect precision —
    # the 0.5% measurement-grain floor applies (round-4 review)
    assert s["ci95"][0] < 5.0 < s["ci95"][1]


def test_summarize_degenerate_mad_keeps_nonzero_ci():
    """MAD = 0 whenever >= half the samples collide (timer-grain
    quantization). The CI must fall back to the half-range / grain
    floor, or arbitrarily small deltas read as 'significant' — the
    opposite of the noise gate's purpose (round-4 review)."""
    s = stats.summarize([91.6, 91.6, 91.6, 91.58, 91.62])
    assert s["mad"] == 0.0
    lo, hi = s["ci95"]
    assert hi - lo > 0.0
    # a -0.1% baseline sits INSIDE the grain-floored interval
    assert lo < 91.5 * 1.0005 and stats.intervals_overlap(
        [91.5, 91.5], [lo, hi])


def test_gate_delta_follows_the_median_not_best_of():
    """The CI verdict describes the medians, so the printed delta must
    be the median delta: a best-of spike in the baseline must not flip
    an improvement into a 'significant regression' (round-4 review)."""
    # current: best 90 but median 89; baseline: one 92 spike, median 85
    cur = _row(g=90.0, samples=[89.0, 88.9, 89.1, 89.0, 90.0])
    old = _row(g=92.0, samples=[85.0, 84.9, 85.1, 85.0, 92.0])
    rows = report.build_rows([cur], [old])
    assert rows[0]["significant"] is True
    assert rows[0]["delta_pct"] > 0  # median improved: +4.7%
    assert report.gate(rows) == []  # NOT a regression


def test_intervals_overlap():
    assert stats.intervals_overlap([1, 3], [2, 4])
    assert stats.intervals_overlap([1, 3], [3, 4])  # touching counts
    assert not stats.intervals_overlap([1, 2], [3, 4])
    assert not stats.intervals_overlap([3, 4], [1, 2])


def test_significantly_better():
    clear_win = stats.summarize([12.0, 12.1, 12.2, 11.9, 12.05])
    assert stats.significantly_better(clear_win, 10.0)
    within_noise = stats.summarize([10.1, 10.4, 9.6, 9.9, 10.0])
    assert not stats.significantly_better(within_noise, 10.0)


def _row(backend="sharded", shape=(64, 128), steps=32, g=50.0,
         samples=None, **kw):
    r = {"backend": backend, "workload": "compute", "shape": list(shape),
         "steps": steps, "boundary": "zero", "gcells_per_sec": g, **kw}
    if samples:
        r["samples_gcells"] = samples
        r["stats"] = stats.summarize(samples)
    return r


def test_report_dispersion_column():
    rows = report.build_rows([_row(samples=[49.5, 50.0, 50.5, 49.8, 50.2])])
    md = report.render_markdown(rows)
    assert "median ± MAD" in md
    assert "±" in md.splitlines()[4]


def test_regression_gate_is_ci_overlap_not_point_delta():
    """-3% inside overlapping CIs is noise (no gate failure); -3% with
    disjoint CIs is a significant regression (gate failure)."""
    noisy_new = _row(g=48.5, samples=[48.5, 50.5, 49.0, 51.0, 49.5])
    noisy_old = _row(g=50.0, samples=[50.0, 48.8, 50.8, 49.2, 50.3])
    rows = report.build_rows([noisy_new], [noisy_old])
    assert rows[0]["within_noise"] is True
    assert report.gate(rows) == []
    md = report.render_markdown(rows)
    assert "~" in md  # marked as within noise

    tight_new = _row(g=48.5, samples=[48.5, 48.6, 48.4, 48.55, 48.5])
    tight_old = _row(g=50.0, samples=[50.0, 50.1, 49.9, 50.05, 50.0])
    rows = report.build_rows([tight_new], [tight_old])
    assert rows[0]["significant"] is True
    bad = report.gate(rows)
    assert len(bad) == 1 and bad[0]["delta_pct"] < 0


def test_gate_ignores_significant_improvements():
    up = _row(g=55.0, samples=[55.0, 55.1, 54.9, 55.05, 55.0])
    old = _row(g=50.0, samples=[50.0, 50.1, 49.9, 50.05, 50.0])
    rows = report.build_rows([up], [old])
    assert rows[0]["significant"] is True
    assert report.gate(rows) == []


def test_svg_plot_renders_series_and_bands():
    rows = report.build_rows([
        _row(shape=(64, 128), g=40.0, samples=[39, 40, 41, 40, 40]),
        _row(shape=(128, 256), g=50.0, samples=[49, 50, 51, 50, 50]),
        _row(backend="fused", shape=(64, 128), g=4.0,
             samples=[3.9, 4.0, 4.1, 4.0, 4.0]),
        _row(backend="fused", shape=(128, 256), g=5.0,
             samples=[4.9, 5.0, 5.1, 5.0, 5.0]),
    ])
    svg = report.render_svg(rows)
    assert svg.startswith("<svg")
    assert svg.count("<path d='M") >= 4  # 2 lines + 2 CI bands
    # fixed ladder-position palette: fused=slot 4, sharded=slot 5 — the
    # assignment follows the entity, not the subset swept
    assert "#eda100" in svg and "#e87ba4" in svg
    assert "Gcell/s" in svg
    # one-size data renders no plot (a table says it better)
    assert report.render_svg(report.build_rows([_row()])) == ""


def test_html_report_embeds_svg():
    rows = report.build_rows([
        _row(shape=(64, 128), g=40.0, samples=[39, 40, 41, 40, 40]),
        _row(shape=(128, 256), g=50.0, samples=[49, 50, 51, 50, 50]),
    ])
    html = report.render_html(rows)
    assert "<svg" in html and "<table>" in html


def test_gate_cli_exit_code(tmp_path):
    from grayscott_tpu.bench.harness import main

    cur = tmp_path / "cur.json"
    base = tmp_path / "base.json"
    tight_new = _row(g=48.5, samples=[48.5, 48.6, 48.4, 48.55, 48.5])
    tight_old = _row(g=50.0, samples=[50.0, 50.1, 49.9, 50.05, 50.0])
    cur.write_text(json.dumps([tight_new]))
    base.write_text(json.dumps([tight_old]))
    out = tmp_path / "r.md"
    rc = main(["--report", str(cur), "--baseline", str(base),
               "--gate", "-o", str(out)])
    assert rc == 1
    # same numbers but noisy: passes
    noisy_new = _row(g=48.5, samples=[48.5, 50.5, 49.0, 51.0, 49.5])
    noisy_old = _row(g=50.0, samples=[50.0, 48.8, 50.8, 49.2, 50.3])
    cur.write_text(json.dumps([noisy_new]))
    base.write_text(json.dumps([noisy_old]))
    rc = main(["--report", str(cur), "--baseline", str(base),
               "--gate", "-o", str(out)])
    assert rc == 0
