"""Parallelism (counterpart of :mod:`apex_tpu.parallel`).

Only the blockwise int8 codec of :mod:`apex_tpu_torch.parallel.comm` is
ported so far: the serving stack's int8 KV and weight wires use it.
"""
