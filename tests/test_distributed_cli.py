"""Multi-process `simulate` END-TO-END (VERDICT r3 #6): the real console
script, two coordinated processes on CPU, sharded backend — primary-only
HDF5 writer, per-image collective fetch, checkpoint/resume across a full
process restart, and one failure-injection case (peer killed mid-run →
clean bounded abort of the survivor, not a hang).

Extends tests/test_distributed.py (library level) to the binary level.
Runbook for real multi-host slices: README "Multi-host runbook".
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(rank: int, port: int, heartbeat: int = 10) -> dict:
    env = dict(
        os.environ,
        GRAYSCOTT_COORDINATOR=f"127.0.0.1:{port}",
        GRAYSCOTT_NUM_PROCESSES="2",
        GRAYSCOTT_PROCESS_ID=str(rank),
        GRAYSCOTT_HEARTBEAT_S=str(heartbeat),
        GRAYSCOTT_PLATFORM="cpu",
        GRAYSCOTT_BACKEND="sharded",
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
        # keep the test's compiles out of the checkout's cache
        GRAYSCOTT_NO_PERSISTENT_CACHE="1",
    )
    env.pop("JAX_PLATFORM_NAME", None)
    return env


def _launch(rank: int, port: int, args: list[str], heartbeat: int = 10):
    return subprocess.Popen(
        [sys.executable, "-u", "-m", "grayscott_tpu.cli.simulate"] + args,
        env=_env(rank, port, heartbeat), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def _run_pair(args: list[str], timeout: int = 300):
    port = _free_port()
    procs = [_launch(r, port, args) for r in range(2)]
    outputs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed simulate timed out")
        outputs.append(stdout)
    return procs, outputs


BASE = ["-r", "32", "-c", "24", "-e", "4",
        "--sharded-steps-per-exchange", "4"]


def _oracle_v(steps: int) -> np.ndarray:
    from grayscott_tpu import oracle
    from grayscott_tpu.params import Parameters
    from grayscott_tpu.species import initial_uv

    u0, v0 = initial_uv((32, 24))
    _, v = oracle.run(u0, v0, Parameters(), steps, "naive")
    return v


def test_cli_two_process_simulate(tmp_path):
    """The real console script across two processes: both ranks compute
    the sharded collective, rank 0 alone writes the HDF5 file, and the
    physics matches the oracle."""
    out = tmp_path / "dist.h5"
    procs, outputs = _run_pair(BASE + ["-n", "3", "-o", str(out)])
    for rank, (p, so) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {rank}:\n{so[-3000:]}"
    assert out.exists()
    import h5py

    with h5py.File(out, "r") as f:
        data = f["matrix"][...]
    assert data.shape == (3, 32, 24)
    np.testing.assert_allclose(data[-1], _oracle_v(12), rtol=0, atol=1e-6)
    # only the primary holds the writer: rank 1 logged no write
    assert "wrote 3 images" in outputs[0]


def test_cli_checkpoint_resume_across_restart(tmp_path):
    """Split run (2 images -> checkpoint -> restart both processes ->
    resume for 2 more) equals a straight 4-image run — state survives a
    FULL multi-process restart."""
    ck = tmp_path / "state.ckpt.h5"
    out1 = tmp_path / "part1.h5"
    out2 = tmp_path / "part2.h5"
    procs, outputs = _run_pair(
        BASE + ["-n", "2", "-o", str(out1), "--checkpoint", str(ck)])
    for rank, (p, so) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {rank}:\n{so[-3000:]}"
    assert ck.exists()
    procs, outputs = _run_pair(
        BASE + ["-n", "2", "-o", str(out2), "--resume", str(ck)])
    for rank, (p, so) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {rank}:\n{so[-3000:]}"
    import h5py

    with h5py.File(out2, "r") as f:
        data = f["matrix"][...]
    # image 2 of the resumed run = image 4 overall = 16 steps
    np.testing.assert_allclose(data[-1], _oracle_v(16), rtol=0, atol=1e-6)


def test_cli_peer_failure_aborts_survivor(tmp_path):
    """Failure injection: rank 1 dies mid-run (SIGKILL); rank 0 must
    exit NONZERO within the heartbeat-bounded window — a clean abort,
    not a hang on the next collective."""
    out = tmp_path / "doomed.h5"
    port = _free_port()
    # enough images that the run is still going when the peer dies
    args = BASE + ["-n", "100000", "-o", str(out)]
    p0 = _launch(0, port, args, heartbeat=10)
    p1 = _launch(1, port, args, heartbeat=10)
    try:
        # let the pair connect and start computing, then kill rank 1
        time.sleep(30)
        assert p0.poll() is None, p0.communicate()[0][-2000:]
        p1.send_signal(signal.SIGKILL)
        try:
            stdout, _ = p0.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            pytest.fail("survivor hung after peer death (no heartbeat "
                        "abort)")
        assert p0.returncode != 0, (
            f"survivor exited 0 after peer death:\n{stdout[-2000:]}")
    finally:
        for p in (p0, p1):
            if p.poll() is None:
                p.kill()
