import http.client
import os
import socket
import threading
import time

import numpy as np
import pytest

from grayscott_tpu.cli import livesim


def test_headless_frames(tmp_path):
    rc = livesim.main(
        ["-r", "24", "-c", "32", "--backend", "fused",
         "--frames", "3", "--output-dir", str(tmp_path / "frames")]
    )
    assert rc == 0
    names = sorted(os.listdir(tmp_path / "frames"))
    assert names == ["0.png", "1.png", "2.png"]
    from PIL import Image

    img = np.asarray(Image.open(tmp_path / "frames" / "2.png"))
    assert img.shape == (24, 32, 3)
    assert img.max() > 0  # the V=1 box maps to bright INFERNO colors


def _free_port() -> int:
    """An ephemeral port: fixed test ports collide with servers left
    behind by OTHER pytest processes on the machine (daemon server
    threads outlive their test), silently talking to the wrong sim."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_web_stream_smoke():
    port = _free_port()
    args = livesim.build_parser().parse_args(
        ["-r", "16", "-c", "16", "--backend", "fused", "--port", str(port)]
    )
    src = livesim.FrameSource(args)
    from grayscott_tpu.utils.logs import init_logging

    t = threading.Thread(
        target=livesim.run_web,
        args=(src, port, 60.0, init_logging(prefer_syslog=False)),
        daemon=True,
    )
    t.start()
    deadline = time.time() + 10
    data = b""
    while time.time() < deadline:
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            conn.request("GET", "/stream")
            resp = conn.getresponse()
            assert resp.status == 200
            assert "multipart/x-mixed-replace" in resp.getheader("Content-Type")
            data = resp.read(4096)
            conn.close()
            break
        except (ConnectionRefusedError, OSError):
            time.sleep(0.2)
    assert b"image/jpeg" in data


def test_steps_per_frame_default_is_one():
    args = livesim.build_parser().parse_args(["--backend", "fused"])
    assert args.nbextrastep is None  # -> 1 in FrameSource (main.rs:77 analog)


def _get_json(port, path):
    import json

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    conn.request("GET", path)
    resp = conn.getresponse()
    assert resp.status == 200
    out = json.loads(resp.read())
    conn.close()
    return out


def test_web_controls():
    """/state, /set (live param change preserving state), /toggle, /reset."""
    port = _free_port()
    args = livesim.build_parser().parse_args(
        ["-r", "16", "-c", "16", "--backend", "fused", "--port", str(port)]
    )
    src = livesim.FrameSource(args)
    from grayscott_tpu.utils.logs import init_logging

    t = threading.Thread(
        target=livesim.run_web,
        args=(src, port, 60.0, init_logging(prefer_syslog=False)),
        daemon=True,
    )
    t.start()
    deadline = time.time() + 10
    while time.time() < deadline:
        try:
            state = _get_json(port, "/state")
            break
        except (ConnectionRefusedError, OSError):
            time.sleep(0.2)
    assert state["paused"] is False
    assert state["feedrate"] == 0.014 and state["killrate"] == 0.054

    # advance a bit so the state is non-trivial, then change the physics
    src.next_rgb()
    before = src.species.uv_host()
    state = _get_json(port, "/set?feedrate=0.03&killrate=0.06&steps_per_frame=4")
    assert state["feedrate"] == 0.03 and state["killrate"] == 0.06
    assert state["steps_per_frame"] == 4
    after = src.species.uv_host()  # state carried over to the new sim
    np.testing.assert_array_equal(before[0], after[0])
    np.testing.assert_array_equal(before[1], after[1])

    state = _get_json(port, "/toggle")
    assert state["paused"] is True
    frame1 = src.frame()
    frame2 = src.frame()  # paused: no stepping, identical frame object
    assert frame1 is frame2
    state = _get_json(port, "/toggle")
    assert state["paused"] is False

    state = _get_json(port, "/reset")
    u, v = src.species.uv_host()
    assert u.max() == 1.0 and float(v.sum()) > 0  # standard init box


def test_set_params_carries_state_and_applies_physics():
    """A slider change rebuilds the backend with the new parameters,
    carries the concentration state and step count over, drops the
    old-physics frames in flight, and the new physics applies."""
    from grayscott_tpu import oracle
    from grayscott_tpu.params import Parameters

    args = livesim.build_parser().parse_args(
        ["-r", "16", "-c", "16", "--backend", "fused"]
    )
    src = livesim.FrameSource(args)
    src.next_rgb()
    u, v = src.species.uv_host()
    steps = src.species.steps_performed
    src.set_params(feedrate=0.03, killrate=0.06)
    assert src.sim.params.feed_rate == 0.03
    assert src.sim.params.kill_rate == 0.06
    assert src.species.steps_performed == steps
    np.testing.assert_array_equal(src.species.uv_host()[1], v)
    src.sim.perform_steps(src.species, 1)
    _, ov = oracle.step(u, v, Parameters(feed_rate=0.03, kill_rate=0.06))
    np.testing.assert_allclose(src.species.result_host(), ov, rtol=0,
                               atol=1e-6)


def test_pause_before_first_frame_does_not_advance():
    """ADVICE r2: frame() while paused with nothing rendered yet must
    not advance the simulation (it used to dispatch TWO frame-steps)."""
    args = livesim.build_parser().parse_args(
        ["-r", "16", "-c", "16", "--backend", "fused"]
    )
    src = livesim.FrameSource(args)
    src.paused = True
    rgb = src.frame()
    assert rgb.shape == (16, 16, 3)
    assert src.species.steps_performed == 0
    # repeated paused frames stay put
    src.frame()
    assert src.species.steps_performed == 0
    # unpausing resumes the pipeline
    src.paused = False
    src.frame()
    assert src.species.steps_performed >= 1


def test_headless_drains_pipeline(tmp_path):
    """ADVICE r2: N headless outputs should cost N frame-steps — the
    final in-flight frames are drained and rendered, not discarded —
    at ANY pipeline depth, including depth > N and N == 1."""
    for depth, frames in ((1, 3), (3, 3), (3, 5), (4, 2), (3, 1)):
        args = livesim.build_parser().parse_args(
            ["-r", "16", "-c", "16", "--backend", "fused",
             "--frames-in-flight", str(depth)]
        )
        src = livesim.FrameSource(args)
        out = tmp_path / f"f{depth}_{frames}"
        rc = livesim.run_headless(src, frames, str(out))
        assert rc == 0
        assert len(os.listdir(out)) == frames
        assert src.species.steps_performed == frames * src.steps_per_frame
        assert not src._pending  # fully drained


def test_frames_in_flight_depth_and_ordering():
    """The pipeline keeps `depth` frames in flight at steady state, and
    every frame is shown exactly once, in order: consecutive next_idx
    results equal a serial replay of the same simulation."""
    def run(extra):
        args = livesim.build_parser().parse_args(
            ["-r", "16", "-c", "16", "--backend", "fused"] + extra
        )
        src = livesim.FrameSource(args)
        return src, [src.next_idx().copy() for _ in range(6)]

    src3, seq3 = run(["--frames-in-flight", "3"])
    assert src3.frames_in_flight == 3
    # steady state: depth-1 frames remain queued after each show
    assert len(src3._pending) == 2
    # dispatched = shown + in flight
    assert src3.species.steps_performed == 6 + 2
    src1, seq1 = run(["--frames-in-flight", "1"])
    for a, b in zip(seq3, seq1):
        np.testing.assert_array_equal(a, b)


def test_set_params_drops_stale_frames_at_depth():
    """A parameter edit discards ALL queued old-physics frames: the next
    shown frame reflects the new physics (modulo the state already
    advanced on device)."""
    args = livesim.build_parser().parse_args(
        ["-r", "16", "-c", "16", "--backend", "fused",
         "--frames-in-flight", "3"]
    )
    src = livesim.FrameSource(args)
    src.next_idx()
    assert len(src._pending) == 2
    src.set_params(feedrate=0.05)
    assert len(src._pending) == 0


def test_pause_at_depth_keeps_queue_for_resume():
    """Pause before anything rendered shows the oldest in-flight frame
    without dispatching; the remaining queue survives for resume."""
    args = livesim.build_parser().parse_args(
        ["-r", "16", "-c", "16", "--backend", "fused",
         "--frames-in-flight", "3"]
    )
    src = livesim.FrameSource(args)
    src.next_idx()  # fill pipeline: 3 dispatched, 2 queued
    steps = src.species.steps_performed
    src._last_idx = None
    src.paused = True
    src.frame_idx()
    assert src.species.steps_performed == steps  # no new dispatch
    assert len(src._pending) == 1  # one shown, one kept
    src.paused = False
    src.frame_idx()  # resume: shows the kept frame, tops the queue up
    assert src.species.steps_performed > steps


def test_canvas_endpoints():
    """Client-side colorization endpoints (VERDICT r3 #8): /palette.bin
    serves the LUT, /frame.bin serves raw palette indices (1 B/px) and
    advances the sim; the default page carries the canvas renderer."""
    port = _free_port()
    args = livesim.build_parser().parse_args(
        ["-r", "16", "-c", "24", "--backend", "fused", "--port", str(port)]
    )
    src = livesim.FrameSource(args)
    from grayscott_tpu.utils.logs import init_logging

    t = threading.Thread(
        target=livesim.run_web,
        args=(src, port, 30.0, init_logging()), daemon=True,
    )
    t.start()
    deadline = time.time() + 20
    conn = None
    while time.time() < deadline:
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            conn.request("GET", "/state")
            state = conn.getresponse()
            import json

            st = json.loads(state.read())
            break
        except (ConnectionRefusedError, OSError):
            time.sleep(0.2)
    assert st["rows"] == 16 and st["cols"] == 24 and st["palette_n"] == 256
    conn.request("GET", "/palette.bin")
    pal = conn.getresponse().read()
    assert len(pal) == 256 * 3
    conn.request("GET", "/frame.bin")
    frame = conn.getresponse().read()
    assert len(frame) == 16 * 24  # 1 byte per pixel
    assert src.species.steps_performed >= 1  # the GET advanced the sim
    # LUT application reproduces the server-side colorize exactly
    idx = np.frombuffer(frame, np.uint8).reshape(16, 24)
    rgb = np.frombuffer(pal, np.uint8).reshape(-1, 3)[idx]
    assert rgb.shape == (16, 24, 3) and rgb.max() > 0
    conn.request("GET", "/")
    page = conn.getresponse().read().decode()
    assert "canvas" in page and "/frame.bin" in page and "/palette.bin" in page


def test_frame_bin_honors_fps_cap():
    """--fps-cap must bound the pull path too: the canvas page polls
    /frame.bin at the client's requestAnimationFrame rate (60-144 Hz),
    which otherwise drives the simulation past the user's cap
    (round-4 review)."""
    port = _free_port()
    args = livesim.build_parser().parse_args(
        ["-r", "16", "-c", "24", "--backend", "fused", "--port", str(port)]
    )
    src = livesim.FrameSource(args)
    from grayscott_tpu.utils.logs import init_logging

    t = threading.Thread(
        target=livesim.run_web,
        args=(src, port, 5.0, init_logging()), daemon=True,  # 5 fps cap
    )
    t.start()
    deadline = time.time() + 20
    conn = None
    while time.time() < deadline:
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            conn.request("GET", "/frame.bin")
            conn.getresponse().read()
            break
        except (ConnectionRefusedError, OSError):
            time.sleep(0.2)
    # 5 back-to-back fetches at a 5 fps cap must take >= ~4 pacing
    # intervals (200 ms each); uncapped they complete in milliseconds
    t0 = time.time()
    for _ in range(5):
        conn.request("GET", "/frame.bin")
        conn.getresponse().read()
    assert time.time() - t0 >= 0.6


def test_diverged_field_nan_safe_index_any_palette():
    """NaNs from a diverged run map to palette index 0 on the device
    index path for EVERY palette resolution — clip propagates NaN and a
    NaN cast is an arbitrary out-of-range LUT index (round-4 review;
    the 512-entry palette used to IndexError)."""
    for res in (64, 256, 512):
        args = livesim.build_parser().parse_args(
            ["-r", "8", "-c", "16", "--backend", "fused",
             "--color-palette-resolution", str(res)]
        )
        src = livesim.FrameSource(args)
        import jax.numpy as jnp

        bad = jnp.full((8, 16), np.nan, jnp.float32)
        idx = np.asarray(src._to_index(bad))
        assert idx.min() == 0 and idx.max() == 0
        rgb = src.lut[idx]  # must not IndexError
        assert rgb.shape == (8, 16, 3)


def test_headless_single_frame_costs_one_frame_step(tmp_path):
    """--frames 1 dispatches exactly one frame-step (round-4 review: the
    cold-start drain used to dispatch a second, never-rendered frame)."""
    args = livesim.build_parser().parse_args(
        ["-r", "8", "-c", "16", "-e", "4", "--backend", "fused",
         "--frames", "1", "--output-dir", str(tmp_path)]
    )
    src = livesim.FrameSource(args)
    livesim.run_headless(src, 1, str(tmp_path))
    assert src.species.steps_performed == 4  # one 4-step frame


def test_set_params_is_atomic_on_bad_values():
    """A bad later value must leave NO earlier value applied: args
    half-mutated without a sim rebuild means the next unrelated /set
    silently applies the rejected change (round-4 review)."""
    args = livesim.build_parser().parse_args(
        ["-r", "8", "-c", "16", "--backend", "fused"]
    )
    src = livesim.FrameSource(args)
    before = src.state()["feedrate"]
    with pytest.raises(ValueError):
        src.set_params(feedrate="0.03", killrate="abc")
    assert src.args.feedrate != 0.03
    assert src.state()["feedrate"] == before
