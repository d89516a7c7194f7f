"""Deterministic, seeded fault injection for the SIMULATED machine
(DESIGN.md §12), the JAX package's `faults/` for the port.

Three fault classes: core fail-stop at a scheduled step, link failure or
degradation (detours with extra latency, counted as rerouted messages),
and transient L1/LLC bit flips under a SECDED ECC model (corrected and
detected-uncorrectable counters; a DUE may escalate to a fail-stop).
Randomness is the counter-based PRNG of `prng.py`, keyed on (seed, step,
site), so the host can tell in advance on which steps a core may die.
"""
