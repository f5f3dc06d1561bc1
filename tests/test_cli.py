"""End-to-end CLI tests: the analog of the reference's CI smoke tests
(.github/workflows/ci.yml:179-229: run `simulate -n 10` then `data-to-pics`
for each backend) — plus numerical output validation the reference lacks."""

import os

import numpy as np
import pytest

from grayscott_tpu import oracle
from grayscott_tpu.cli import data_to_pics, simulate
from grayscott_tpu.io.hdf5 import Reader
from grayscott_tpu.species import initial_uv


@pytest.mark.parametrize("backend", ["naive", "fused"])
def test_simulate_then_pics(tmp_path, backend):
    out = tmp_path / "output.h5"
    rc = simulate.main(
        [
            "-n", "4", "-r", "24", "-c", "32", "-e", "8",
            "--backend", backend, "-o", str(out),
        ]
    )
    assert rc == 0
    with Reader(out) as r:
        assert r.num_images == 4
        assert r.image_shape == (24, 32)
        frames = list(r)
    # image i holds V after (i+1)*8 steps; check against the oracle
    from grayscott_tpu.params import Parameters

    u, v = initial_uv((24, 32))
    for frame in frames:
        u, v = oracle.run(u, v, Parameters(), 8)
        np.testing.assert_allclose(frame, v, rtol=0, atol=1e-5)

    picdir = tmp_path / "pics"
    rc = data_to_pics.main(["-i", str(out), "-o", str(picdir)])
    assert rc == 0
    names = sorted(os.listdir(picdir))
    assert names == ["0.png", "1.png", "2.png", "3.png"]
    from PIL import Image

    img = np.asarray(Image.open(picdir / "0.png"))
    assert img.shape == (24, 32, 3)


def test_simulate_parameter_overrides(tmp_path):
    out = tmp_path / "o.h5"
    rc = simulate.main(
        [
            "-n", "1", "-r", "16", "-c", "16", "-e", "2",
            "-k", "0.06", "-f", "0.02", "-t", "0.5",
            "--backend", "fused", "-o", str(out),
        ]
    )
    assert rc == 0
    from grayscott_tpu.params import Parameters

    u, v = initial_uv((16, 16))
    u, v = oracle.run(
        u, v, Parameters(kill_rate=0.06, feed_rate=0.02, time_step=0.5), 2
    )
    with Reader(out) as r:
        np.testing.assert_allclose(r.read(), v, rtol=0, atol=1e-6)


def test_zero_boundary_cli(tmp_path):
    out = tmp_path / "o.h5"
    rc = simulate.main(
        ["-n", "1", "-r", "16", "-c", "16", "-e", "3",
         "--boundary", "zero", "--backend", "regular", "-o", str(out)]
    )
    assert rc == 0
    from grayscott_tpu.params import Parameters

    u, v = initial_uv((16, 16))
    u, v = oracle.run(u, v, Parameters(), 3, boundary="zero")
    with Reader(out) as r:
        np.testing.assert_allclose(r.read(), v, rtol=0, atol=1e-6)


def test_default_output_name():
    from grayscott_tpu.cli.shared import simulation_output_path

    assert simulation_output_path(None) == "output.h5"
    assert simulation_output_path("x.h5") == "x.h5"


def test_pics_zero_padding(tmp_path):
    """Width = ilog10(n) + 1 (data-to-pics/src/main.rs:97-104)."""
    from grayscott_tpu.io.hdf5 import Writer

    out = tmp_path / "many.h5"
    with Writer(out, (4, 4), 11) as w:
        for _ in range(11):
            w.write(np.zeros((4, 4), np.float32))
    picdir = tmp_path / "pics"
    data_to_pics.main(["-i", str(out), "-o", str(picdir), "--output-threads", "2"])
    names = sorted(os.listdir(picdir))
    assert names[0] == "00.png" and names[-1] == "10.png"


def test_simulate_sharded_backend(tmp_path):
    """The multi-device backend through the real CLI on the virtual mesh."""
    out = tmp_path / "s.h5"
    rc = simulate.main(
        ["-n", "1", "-r", "16", "-c", "16", "-e", "2",
         "--backend", "sharded", "--sharded-devices", "2",
         "--sharded-steps-per-exchange", "2", "-o", str(out)]
    )
    assert rc == 0
    from grayscott_tpu.params import Parameters

    u, v = initial_uv((16, 16))
    u, v = oracle.run(u, v, Parameters(), 2)
    with Reader(out) as r:
        np.testing.assert_allclose(r.read(), v, rtol=0, atol=1e-6)


def test_simulate_deterministic(tmp_path):
    """Two identical runs produce bit-identical HDF5 output."""
    outs = []
    for name in ("a.h5", "b.h5"):
        out = tmp_path / name
        assert simulate.main(
            ["-n", "3", "-r", "24", "-c", "32", "-e", "4",
             "--backend", "fused", "-o", str(out)]
        ) == 0
        with Reader(out) as r:
            outs.append(np.stack(list(r)))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_simulate_writer_failure_raises(tmp_path, monkeypatch):
    """A dying HDF5 writer thread must surface its error, not deadlock
    the compute loop on a full queue (the bounded-put regression)."""
    from grayscott_tpu.io import hdf5

    def boom(self, img):
        raise OSError("disk full")

    monkeypatch.setattr(hdf5.Writer, "write", boom)
    with pytest.raises(OSError, match="disk full"):
        simulate.main([
            "-n", "6", "-r", "24", "-c", "32", "-e", "2",
            "--backend", "naive", "-o", str(tmp_path / "x.h5"),
        ])


def test_data_to_pics_writer_failure_raises(tmp_path, monkeypatch):
    """All PNG writer threads dying must abort the pipeline with the
    error instead of deadlocking on the bounded queue."""
    out = tmp_path / "in.h5"
    simulate.main(["-n", "6", "-r", "24", "-c", "32", "-e", "2",
                   "--backend", "naive", "-o", str(out)])
    from grayscott_tpu import native

    monkeypatch.setattr(native, "png_encode",
                        lambda *a, **k: (_ for _ in ()).throw(
                            OSError("unwritable")))
    import PIL.Image

    def boom(self, *a, **k):
        raise OSError("unwritable")

    monkeypatch.setattr(PIL.Image.Image, "save", boom)
    with pytest.raises(OSError, match="unwritable"):
        data_to_pics.main(["-i", str(out), "-o", str(tmp_path / "pics"),
                           "--output-threads", "2"])


def test_run_pipeline_sink_receives_every_image_in_order():
    """The factored snapshot loop (what simulate.main and chip_smoke.py
    drive): N batches -> N float32 images handed to the sink in order,
    each the state after its own batch."""
    from grayscott_tpu.backends import get_backend
    from grayscott_tpu.params import Parameters

    sim = get_backend("fused")(Parameters())
    species = sim.make_species((16, 24))
    images = []
    simulate.run_pipeline(sim, species, 3, 4, images.append,
                          output_buffer=1)
    assert len(images) == 3 and species.steps_performed == 12
    u, v = initial_uv((16, 24))
    for image in images:
        u, v = oracle.run(u, v, Parameters(), 4)
        assert image.dtype == np.float32
        np.testing.assert_allclose(image, v, rtol=0, atol=1e-6)


def test_run_pipeline_reraises_sink_error():
    from grayscott_tpu.backends import get_backend
    from grayscott_tpu.params import Parameters

    sim = get_backend("fused")(Parameters())
    species = sim.make_species((8, 8))

    def sink(image):
        raise OSError("disk full")

    with pytest.raises(OSError, match="disk full"):
        simulate.run_pipeline(sim, species, 5, 1, sink, output_buffer=1)


def test_simulate_snapshot_dtype_bf16(tmp_path):
    """--snapshot-dtype bfloat16 halves the transfer; the HDF5 file stays
    float32 and matches the f32 run to bf16 precision."""
    import h5py
    import numpy as np

    from grayscott_tpu.cli import simulate

    a = tmp_path / "f32.h5"
    b = tmp_path / "bf16.h5"
    base = ["-n", "3", "-r", "24", "-c", "32", "-e", "4",
            "--backend", "fused"]
    assert simulate.main(base + ["-o", str(a)]) == 0
    assert simulate.main(
        base + ["-o", str(b), "--snapshot-dtype", "bfloat16"]
    ) == 0
    with h5py.File(a) as fa, h5py.File(b) as fb:
        va, vb = fa["matrix"][:], fb["matrix"][:]
    assert vb.dtype == np.float32
    np.testing.assert_allclose(va, vb, rtol=0, atol=0.01)
    assert np.abs(va - vb).max() > 0  # rounding actually happened


def test_simulate_preset_flag(tmp_path):
    """--preset supplies the (feed, kill) pair; explicit -f overrides."""
    out = tmp_path / "p.h5"
    rc = simulate.main(
        ["-n", "1", "-r", "16", "-c", "16", "-e", "2", "--preset", "coral",
         "-f", "0.02", "--backend", "fused", "-o", str(out)]
    )
    assert rc == 0
    from grayscott_tpu.params import PRESETS, Parameters

    u, v = initial_uv((16, 16))
    u, v = oracle.run(
        u, v,
        Parameters(feed_rate=0.02, kill_rate=PRESETS["coral"][1]), 2,
    )
    with Reader(out) as r:
        np.testing.assert_allclose(r.read(), v, rtol=0, atol=1e-6)


def test_write_gif_zero_frames_raises_cleanly(tmp_path):
    """A zero-frame HDF5 file raises a clear ValueError instead of
    leaking a bare StopIteration out of write_gif."""
    import h5py
    import pytest

    # our own Writer refuses n=0 (h5py chunking), but a foreign/truncated
    # file can still present an empty "matrix" dataset
    empty = tmp_path / "empty.h5"
    with h5py.File(empty, "w") as f:
        f.create_dataset("matrix", shape=(0, 8, 8), dtype="f4")
    with pytest.raises(ValueError, match="no frames"):
        data_to_pics.write_gif(str(tmp_path / "x.gif"), str(empty), 10.0)


def test_data_to_pics_gif_export(tmp_path):
    """--gif assembles an animated GIF whose frames are the same
    palette-indexed INFERNO colorization as the PNGs."""
    out = tmp_path / "output.h5"
    rc = simulate.main(["-n", "5", "-r", "24", "-c", "32", "-e", "4",
                        "--backend", "fused", "-o", str(out)])
    assert rc == 0
    picdir = tmp_path / "pics"
    gif = tmp_path / "run.gif"
    rc = data_to_pics.main(["-i", str(out), "-o", str(picdir),
                            "--gif", str(gif), "--gif-fps", "10"])
    assert rc == 0
    from PIL import Image

    with Image.open(gif) as im:
        assert im.format == "GIF"
        assert im.n_frames == 5
        assert im.size == (32, 24)
        assert im.info.get("duration") == 100  # 10 fps
        # frame colors match the PNG path's LUT: compare frame 0
        im.seek(0)
        rgb = np.asarray(im.convert("RGB"))
    png0 = np.asarray(Image.open(sorted(picdir.iterdir())[0]))
    # GIF uses nearest-index sampling vs the PNG's interpolated LUT:
    # identical up to one LUT step
    assert np.abs(rgb.astype(int) - png0.astype(int)).max() <= 16
