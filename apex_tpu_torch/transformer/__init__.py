"""Transformer building blocks of the port (counterpart of
:mod:`apex_tpu.transformer`)."""
