"""Result attestation (DESIGN.md §24), the JAX package's `attest/` for
the port:

- `SoloAttest` / `FleetAttest` — per-chunk chain holders the engines
  call at every committed chunk boundary (off by default: engines hold
  `self.attest = None` and never touch state).
- `AttestChain`, `chunk_digest`, `comparable`, `heads_equal`, `link` —
  the chain primitives.
- `toolchain_fingerprint` / `toolchain_matches` — lease-time toolchain
  verification.
- `AttestationError` — typed error on the CLI's exit-2 contract.

The offline audit (`attest/audit.py`, the `audit` verb) needs the pool
and is not ported yet.
"""

from .chain import (AttestChain, FleetAttest, SoloAttest, chunk_digest,
                    comparable, heads_equal, link, toolchain_fingerprint,
                    toolchain_matches)
from .errors import AttestationError

__all__ = [
    "AttestChain", "FleetAttest", "SoloAttest", "chunk_digest",
    "comparable", "heads_equal", "link", "toolchain_fingerprint",
    "toolchain_matches", "AttestationError",
]
