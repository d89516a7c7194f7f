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

- `audit.run_audit` — the offline replay audit of a pool directory (the
  `audit` verb): every DONE unit re-executed on the device and its chain
  head held against the ledger's (imported on its own: it pulls in the
  fleet).
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
