"""Pipeline parallelism (counterpart of
:mod:`apex_tpu.transformer.pipeline_parallel`).  Only the remat policy
resolution the models share is ported so far (:mod:`.schedules`); the
schedules themselves wait for ROADMAP item 7."""
