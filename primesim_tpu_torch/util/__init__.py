"""Host-side utilities shared by the supervisor and the checkpoint
writer: retry backoff (`backoff.py`) and disk-pressure governance
(`diskpressure.py`), the JAX package's `util/` for the port."""
