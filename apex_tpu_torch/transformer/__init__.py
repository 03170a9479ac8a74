"""Transformer building blocks of the port (counterpart of
:mod:`apex_tpu.transformer`): ``enums``, ``functional.fused_softmax``,
the remat policy resolution of ``pipeline_parallel.schedules`` and
``tensor_parallel.cross_entropy``."""
