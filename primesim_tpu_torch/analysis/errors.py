"""Typed errors of the offline verifier (DESIGN.md §19), the JAX
package's `analysis/errors.py` for the port: `FsckCorrupt` only (the
lint's `AnalysisError` and `RecompileError` check JAX-only contracts and
are not ported).

`FsckCorrupt` rides the CLI error contract: `cli.main` catches it and
prints `{"error": {type, location, detail}}` on stderr with exit code 2,
exactly like TraceError / CheckpointCorrupt. `location()` carries the
first corrupt path and the number of corrupt findings.
"""

from __future__ import annotations


class FsckCorrupt(ValueError):
    """`fsck` found corruption in durable state: a broken CRC chain, an
    illegal state-machine transition, a checkpoint that fails its
    manifest, a warm-cache entry whose key disagrees with its content.
    Carries the first corrupt path plus the total count."""

    def __init__(self, msg: str, *, path: str | None = None,
                 n_corrupt: int = 0):
        super().__init__(msg)
        self.path = path
        self.n_corrupt = n_corrupt

    def location(self) -> dict:
        loc: dict = {"n_corrupt": self.n_corrupt}
        if self.path is not None:
            loc["path"] = self.path
        return loc
