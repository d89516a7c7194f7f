"""Trace ingest beyond a preloaded trace: windowed streaming
(`stream.py`), the capture frontend's shared-memory rings and the
execution-driven engine (`ring.py`), and the capture shim's build and
launch (`capture.py`)."""
