"""Typed errors for the attestation subsystem (DESIGN.md §24), the JAX
package's `attest/errors.py` for the port.

`AttestationError` rides the CLI error contract: `cli.main` catches it
and prints `{"error": {type, location, detail}}` on stderr with exit
code 2, exactly like TraceError / CheckpointCorrupt. `location()`
anchors the failure to the site that detected it (an element
checkpoint's self-digest, a lease grant, an ack compare) plus the unit
and chunk index when known.
"""

from __future__ import annotations


class AttestationError(ValueError):
    """Result integrity could not be established: a fingerprint chain
    diverged between two executions of the same unit, a worker's
    toolchain disagrees with the coordinator's, or an offline audit
    re-derived a different chain head than the journaled one."""

    def __init__(self, msg: str, *, site: str = "", unit: str = "",
                 chunk: int | None = None):
        super().__init__(msg)
        self.site = site
        self.unit = unit
        self.chunk = chunk

    def location(self) -> dict:
        loc: dict = {}
        if self.site:
            loc["site"] = self.site
        if self.unit:
            loc["unit"] = self.unit
        if self.chunk is not None:
            loc["chunk"] = int(self.chunk)
        return loc
