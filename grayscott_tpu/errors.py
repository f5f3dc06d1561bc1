"""Uniform error types for the backend configuration matrix.

Every REJECTED cell of the support matrix (grayscott_tpu/support.py)
raises :class:`UnsupportedConfigError` — one clear error shape for "this
combination is not supported", as opposed to plain ``ValueError`` for
malformed individual arguments (an unknown enum value). Subclasses
``ValueError`` so existing callers catching that stay correct.

The reference analog is clap rejecting invalid flag combinations at
parse time with one error channel (ui/src/lib.rs:18-46).
"""

from __future__ import annotations


class UnsupportedConfigError(ValueError):
    """A configuration COMBINATION the support matrix does not support.

    Carries the offending combination in ``.combo`` (a short string
    naming the interacting knobs) when the raise site provides one, so
    tools can map the rejection back to a support-matrix row.
    """

    def __init__(self, message: str, combo: str | None = None):
        super().__init__(message)
        self.combo = combo
