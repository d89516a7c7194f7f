"""primesim_tpu_torch: the PyTorch/CUDA port of the primesim_tpu simulator.

It imports torch, numpy and the standard library only: never JAX, and no
module of the JAX package `primesim_tpu`, which stays the reference the
port is held against bit for bit. Entry points (`sim.engine.Engine`,
`python -m primesim_tpu_torch run`) run on the CUDA card unless the caller
passes `device="cpu"`.
"""
