"""Device-op attribution from a jax.profiler trace (xplane.pb).

The reader lives in ``grayscott_tpu.utils.xplane``; this CLI prints the
per-line device time of every device plane, largest first.

Usage::

    python scripts/profile_trace.py ...   # capture + reduce
    python scripts/trace_ops.py TRACE_DIR  # attribute any capture
                                           # (default: $TMPDIR/grayscott_trace)

Pass either a trace directory (the newest plugins/profile/*/ run is
used) or an xplane.pb path directly.
"""

from __future__ import annotations

import os
import sys
import tempfile
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from grayscott_tpu.utils import xplane  # noqa: E402


def main(argv=None) -> int:
    args = (argv or sys.argv[1:]) or [
        os.path.join(tempfile.gettempdir(), "grayscott_trace")]
    path = xplane.find_xplane(args[0])
    print(f"# {path}")
    for plane in xplane.device_planes(path):
        print(f"\n== plane: {plane['name']}")
        for lname, events in plane["lines"]:
            if not events:
                continue
            per_op = defaultdict(lambda: [0.0, 0])
            for name, _, dur in events:
                per_op[name][0] += dur
                per_op[name][1] += 1
            total = sum(d for d, _ in per_op.values())
            print(f"-- line: {lname} (total {total / 1e6:.3f} ms)")
            for op, (dur, n) in sorted(
                per_op.items(), key=lambda kv: -kv[1][0]
            )[:20]:
                print(f"   {dur / 1e6:10.3f} ms  x{n:<6} {op[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
