"""Device facts: the capability report, and the published-peak table the
benchmark divides by (grayscott_tpu/bench/roofline.py)."""

from __future__ import annotations

import pytest

from grayscott_tpu.bench import roofline
from grayscott_tpu.utils import device


@pytest.mark.parametrize("kind,bandwidth", [
    ("NVIDIA H100 80GB HBM3", 3.35e12),
    ("NVIDIA H100 PCIe", 2.0e12),
])
def test_peak_table_known_kinds(kind, bandwidth):
    assert roofline.hbm_peak(kind) == bandwidth
    assert roofline.roofline_gcells(kind) == pytest.approx(
        bandwidth / 16 / 1e9)


def test_h100_sxm_roofline_is_about_209_gcells():
    assert roofline.roofline_gcells("NVIDIA H100 80GB HBM3") == \
        pytest.approx(209.375)


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_peak_table_refuses_unknown_kind(kind):
    """A device missing from the table is an error, never a default."""
    with pytest.raises(ValueError, match="no published memory bandwidth"):
        roofline.hbm_peak(kind)
    with pytest.raises(ValueError):
        roofline.roofline_gcells(kind)


def test_card_line_has_no_fallback(monkeypatch, tmp_path):
    """Without nvidia-smi there is no card to name: the query raises."""
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        roofline.card_line()


def test_capability_dump_contents(monkeypatch):
    """The one-shot capability report (device.rs:77-118 analog) names
    the versions, every device with its kind, the compile-cache location
    and the GRAYSCOTT_* environment."""
    import jax

    monkeypatch.setenv("GRAYSCOTT_DEMO_FLAG", "1")
    out = device.capability_dump()
    assert f"jax {jax.__version__}" in out
    assert f"{jax.device_count()} device(s)" in out
    assert "device 0:" in out
    assert f"kind={jax.devices()[0].device_kind!r}" in out
    assert "compile cache:" in out
    assert "GRAYSCOTT_DEMO_FLAG=1" in out


def test_capability_dump_logged_at_debug(caplog):
    """make_simulation emits the dump at DEBUG (the reference logs its
    capability dump at trace level on context build)."""
    import argparse
    import logging

    from grayscott_tpu.cli import shared

    parser = argparse.ArgumentParser()
    shared.add_shared_args(parser)
    ns = parser.parse_args(["-r", "16", "-c", "16", "--backend", "fused"])
    with caplog.at_level(logging.DEBUG, logger="grayscott_tpu"):
        shared.make_simulation(ns)
    assert any("device capabilities" in r.getMessage()
               for r in caplog.records)
