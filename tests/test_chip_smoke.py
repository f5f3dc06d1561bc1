"""chip_smoke.py's phases at small shapes on the CPU test platform, and
its output contract: one JSON result line, printed only when every phase
passed on a GPU."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from conftest import load_chip_smoke

smoke = load_chip_smoke()
SCRIPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "chip_smoke.py")


def test_device_phase_refuses_a_host_without_gpu():
    with pytest.raises(RuntimeError, match="no gpu device"):
        smoke.device_phase()


def test_device_phase_reports_what_jax_sees():
    import jax

    assert smoke.device_phase(platform="cpu") == {
        "platform": "cpu", "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices())}


def test_selector_phase():
    # one-device-sized domain on the 8 virtual devices: fused; the
    # 1080x1920 default is worth splitting over 8 devices
    assert smoke.selector_phase((64, 64)) == "fused"
    assert smoke.selector_phase() == "sharded"


def test_check_raises_above_tolerance(capsys):
    smoke.check("ok", (1e-7, 2e-7), tol=1e-6)
    with pytest.raises(AssertionError, match="above"):
        smoke.check("bad", (1e-7, 2e-6), tol=1e-6)
    with pytest.raises(AssertionError):
        smoke.check("nan", (0.0, float("nan")), tol=1e-6)
    assert "max|dV| = 2.000e-06 (tolerance 1e-06)" in capsys.readouterr().out


def test_parity_phase_small(capsys):
    refs = smoke.parity_phase(shape=(24, 40), steps=20)
    assert set(refs) == {"naive", "zero"}
    out = capsys.readouterr().out
    assert out.count("parity ") == 2 * len(smoke.PARITY_BACKENDS)
    assert "conv" in out and "fused[runtime_weights]" in out


def test_parity_phase_fails_on_a_wrong_backend(monkeypatch):
    real = smoke.run_backend

    def off_by_a_bit(name, shape, steps, boundary, **kw):
        u, v = real(name, shape, steps, boundary, **kw)
        return u, v + 1e-3

    monkeypatch.setattr(smoke, "run_backend", off_by_a_bit)
    with pytest.raises(AssertionError):
        smoke.parity_phase(shape=(16, 16), steps=2, boundaries=("zero",))


def test_pipeline_phase_small():
    image, steps = smoke.pipeline_phase(
        ["-n", "2", "-r", "24", "-c", "32", "--backend", "fused"])
    assert steps == 2 * 32
    _, ov = smoke.oracle_run((24, 32), steps, "naive")
    np.testing.assert_allclose(image, ov, rtol=0, atol=1e-5)


def test_throughput_phase_small(capsys):
    rates = smoke.throughput_phase(shapes=((16, 16),), steps=4, card="c")
    assert set(rates) == {((16, 16), "naive"), ((16, 16), "zero")}
    assert all(r > 0 for r in rates.values())
    assert "Gcell/s" in capsys.readouterr().out


def test_four_card_phase_small(capsys):
    """The --four-cards path on four of the virtual devices: 4x1 and 2x2
    meshes vs one-device fused, and the auto mesh vs the oracle."""
    smoke.four_card_phase(shape=(64, 64), steps=16, oracle_shape=(32, 32),
                          timed_steps=8, card="cpu")
    out = capsys.readouterr().out
    for label in ("sharded 4x1 naive", "sharded 2x2 zero",
                  "vs fused on one card", "vs oracle"):
        assert label in out


def test_main_last_line_contract(monkeypatch, capsys):
    """With every phase passing, the LAST stdout line is exactly the
    result object, and the card line comes before it."""
    gpu = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    from grayscott_tpu.bench import roofline

    monkeypatch.setattr(smoke, "device_phase", lambda: gpu)
    monkeypatch.setattr(roofline, "card_line",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(smoke, "selector_phase", lambda: "fused")
    real_parity, real_pipe = smoke.parity_phase, smoke.pipeline_phase
    real_tp = smoke.throughput_phase
    monkeypatch.setattr(smoke, "PARITY_STEPS", 2 * 16)
    monkeypatch.setattr(smoke, "parity_phase", lambda: real_parity(
        shape=(24, 32), steps=32, backends=(("fused", {}),)))
    monkeypatch.setattr(smoke, "pipeline_phase", lambda: real_pipe(
        ["-n", "2", "-e", "16", "-r", "24", "-c", "32",
         "--backend", "fused"]))
    monkeypatch.setattr(smoke, "throughput_phase", lambda card: real_tp(
        shapes=((16, 16),), steps=2, card=card))
    assert smoke.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {"ok": True, "device": gpu}
    assert lines[-1] == json.dumps({"ok": True, "device": gpu})
    assert any("NVIDIA H100 80GB HBM3, 700.00 W" in ln for ln in lines[:-1])


def test_script_fails_without_gpu_and_prints_no_result():
    proc = subprocess.run([sys.executable, SCRIPT], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no gpu device" in proc.stderr


def test_script_alone_in_a_directory_fails(tmp_path):
    """Without the rest of the repo there is no program to smoke-test."""
    shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
