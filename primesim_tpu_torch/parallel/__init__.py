"""The tile mesh: the machine sharded over several devices
(`sharding.py`) and over several processes (`distributed.py`)."""
