"""Tests that need a GPU: chip_smoke.py's phases on the card at reduced
shapes. They carry the ``gpu`` marker and skip on other platforms; the
decision is taken in a fixture, never at import. Run on a machine with a
GPU with

    GRAYSCOTT_TEST_GPU=1 python -m pytest tests/test_gpu.py -m gpu
"""

import pytest

from conftest import load_chip_smoke

pytestmark = pytest.mark.gpu

smoke = load_chip_smoke()


@pytest.fixture(autouse=True)
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run with GRAYSCOTT_TEST_GPU=1 on a "
                    "machine with one)")


def test_device_and_card():
    info = smoke.device_phase()
    assert info["platform"] == "gpu"
    assert smoke.card_phase()


def test_parity_on_gpu():
    smoke.parity_phase(shape=(256, 384), steps=256)


def test_pipeline_on_gpu():
    image, steps = smoke.pipeline_phase(["-n", "4", "-r", "256", "-c",
                                         "384", "--backend", "fused"])
    _, ov = smoke.oracle_run((256, 384), steps, "naive")
    smoke.check("pipeline", (0.0, float(abs(image - ov).max())))


def test_throughput_on_gpu():
    rates = smoke.throughput_phase(shapes=((1024, 1024),), steps=100)
    assert all(r > 0 for r in rates.values())


def test_four_cards_on_gpu():
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs four GPUs")
    smoke.four_card_phase(shape=(1024, 1024), steps=64,
                          oracle_shape=(256, 256), timed_steps=64)
