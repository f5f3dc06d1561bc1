"""The backend support matrix: one user-facing surface.

Backend x boundary x mesh combinations and their status — the single
source the README table and the CLI ``--help`` epilog render from, and
the contract tests/test_support.py sweeps. Every ``rejected`` cell raises
:class:`grayscott_tpu.errors.UnsupportedConfigError` (a ``ValueError``
subclass) at construction or storage-build time; nothing silently falls
back to another backend.

Reference analog: the backend feature matrix implied by the Cargo
feature graph (compute/selector/src/lib.rs:4-59), where unsupported
combinations fail at compile time. Here it is a runtime matrix, so it
must be documented and enforced uniformly.
"""

from __future__ import annotations

#: (combo, status, note). status: "ok" = supported; "rejected" =
#: UnsupportedConfigError.
MATRIX: tuple[tuple[str, str, str], ...] = (
    ("naive/regular/fused/conv x any boundary x any stencil", "ok",
     "one device; fused (one executable per batch of steps) is the "
     "default there"),
    ("fused runtime_weights x any boundary", "ok",
     "weights and rates are traced operands: parameter changes do not "
     "recompile"),
    ("sharded x 1-D/2-D mesh x any boundary x any stencil", "ok",
     "ppermute halo exchange every K steps; the mesh follows the domain "
     "geometry unless --sharded-mesh-cols pins it"),
    ("sharded x shards shallower than K on a split axis", "rejected",
     "one neighbour must supply the whole K-deep halo"),
    ("sharded x fewer than 1 device or mesh column", "rejected",
     "omit the flag for all devices / automatic factorization"),
)


def render(fmt: str = "markdown") -> str:
    """The support matrix as a markdown table or plain-text epilog."""
    if fmt == "markdown":
        lines = ["| configuration | status | notes |", "|---|---|---|"]
        for combo, status, note in MATRIX:
            lines.append(f"| {combo} | {status} | {note} |")
        return "\n".join(lines)
    width = max(len(c) for c, _, _ in MATRIX)
    lines = ["backend support matrix (a rejected combination raises "
             "UnsupportedConfigError):"]
    for combo, status, note in MATRIX:
        lines.append(f"  {combo:<{width}}  [{status}] {note}")
    return "\n".join(lines)
