"""Observability of the port (counterpart of
:mod:`apex_tpu.observability`); so far the lock-order sanitizer
(:mod:`apex_tpu_torch.observability.locks`).  The metrics board, spans
and the flight recorder wait for ROADMAP item 8."""
