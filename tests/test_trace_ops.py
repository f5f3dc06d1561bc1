"""The trace reductions (grayscott_tpu.utils.xplane, CLI in
scripts/trace_ops.py), exercised against a synthetic XSpace built in the
protobuf wire format, read back through jax.profiler.ProfileData."""

import os
import sys

import pytest

from grayscott_tpu.utils import xplane

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))


def _varint(v: int) -> bytes:
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _field(num: int, wt: int, payload: bytes | int) -> bytes:
    key = _varint(num << 3 | wt)
    if wt == 0:
        return key + _varint(payload)
    return key + _varint(len(payload)) + payload


def _event(mid: int, offset_ps: int, duration_ps: int) -> bytes:
    # XEvent {metadata_id, offset_ps, duration_ps}
    return _field(1, 0, mid) + _field(2, 0, offset_ps) + _field(3, 0,
                                                              duration_ps)


def _build_xspace() -> bytes:
    # XEventMetadata {id, name}, as map entries {key: id, value: meta}
    entries = b""
    for mid, name in ((7, b"fused_multiply"), (8, b"copy")):
        meta = _field(1, 0, mid) + _field(2, 2, name)
        entries += _field(4, 2, _field(1, 0, mid) + _field(2, 2, meta))
    # XLA Modules line: two modules of 1.5 us and 0.5 us
    modules = (_field(2, 2, b"XLA Modules")
               + _field(4, 2, _event(7, 0, 1_500_000))
               + _field(4, 2, _event(7, 3_000_000, 500_000)))
    # a stream line with kernels at [0, 1) us, [0.5, 1.5) us (overlap)
    # and [3, 4) us: busy 2.5 us over a 4 us window
    stream = (_field(2, 2, b"Stream #13(compute)")
              + _field(4, 2, _event(7, 0, 1_000_000))
              + _field(4, 2, _event(8, 500_000, 1_000_000))
              + _field(4, 2, _event(7, 3_000_000, 1_000_000)))
    plane = (_field(2, 2, b"/device:GPU:0") + _field(3, 2, modules)
             + _field(3, 2, stream) + entries)
    host = _field(2, 2, b"/host:CPU")
    # XSpace {planes: [device plane, host plane]}
    return _field(1, 2, plane) + _field(1, 2, host)


def test_parse_synthetic_xspace(tmp_path):
    path = tmp_path / "t.xplane.pb"
    path.write_bytes(_build_xspace())
    planes = xplane.parse_xspace(str(path))
    assert [p["name"] for p in planes] == ["/device:GPU:0", "/host:CPU"]
    (lname, events), _ = planes[0]["lines"]
    assert lname == "XLA Modules"
    assert [(n, d) for n, _, d in events] == [
        ("fused_multiply", 1500.0), ("fused_multiply", 500.0)]
    # host planes are excluded from device summaries
    assert [p["name"] for p in xplane.device_planes(str(path))] == [
        "/device:GPU:0"
    ]


def test_find_xplane_prefers_file_and_dir_layout(tmp_path):
    run = tmp_path / "plugins" / "profile" / "2026_01_01_00_00_00"
    run.mkdir(parents=True)
    pb = run / "host.xplane.pb"
    pb.write_bytes(_build_xspace())
    assert xplane.find_xplane(str(tmp_path)) == str(pb)
    assert xplane.find_xplane(str(pb)) == str(pb)
    with pytest.raises(FileNotFoundError):
        xplane.find_xplane(str(tmp_path / "nope"))


def test_kernel_summary_counts_stream_kernels_and_busy_union(tmp_path):
    run = tmp_path / "plugins" / "profile" / "r1"
    run.mkdir(parents=True)
    (run / "vm.xplane.pb").write_bytes(_build_xspace())
    s = xplane.kernel_summary(str(tmp_path))
    assert s["kernels"] == {
        "fused_multiply": {"ms": pytest.approx(2e-3), "count": 2},
        "copy": {"ms": pytest.approx(1e-3), "count": 1},
    }
    assert s["busy_ms"] == pytest.approx(2.5e-3)
    assert s["window_ms"] == pytest.approx(4e-3)
    assert s["idle_share"] == pytest.approx(1 - 2.5 / 4)


def test_device_workload_needs_device_plane():
    """The bench 'device' workload fails with a clear message on CPU
    (host-only traces carry no kernel on a GPU stream line)."""
    from grayscott_tpu.backends import get_backend
    from grayscott_tpu.bench.harness import run_one
    from grayscott_tpu.params import Parameters

    sim = get_backend("fused")(Parameters())
    with pytest.raises(RuntimeError, match="GPU stream line"):
        run_one(sim, (16, 32), 2, workload="device", reps=1)


def test_trace_ops_cli(tmp_path, capsys):
    run = tmp_path / "plugins" / "profile" / "r1"
    run.mkdir(parents=True)
    (run / "vm.xplane.pb").write_bytes(_build_xspace())
    import trace_ops

    assert trace_ops.main([str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "/device:GPU:0" in out and "fused_multiply" in out
