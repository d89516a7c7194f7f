"""Offline verification of durable state (DESIGN.md §19), the JAX
package's `analysis/` for the port: `fsck` checks journals, pool
ledgers, checkpoints, warm-cache and executable-cache entries with zero
simulation (`fsck.py`), and `fsck --compare` holds two journal chains
(a primary and its replica) to frame-for-frame agreement.

The JAX package's lint (`lint.py`, `rules.py`, `recompile.py`) checks
JAX-only contracts and is not ported; the port's counterpart is
`tests/test_torch_rules.py`.
"""

from .errors import FsckCorrupt
from .fsck import run_compare, run_fsck

__all__ = ["FsckCorrupt", "run_compare", "run_fsck"]
