"""Partitioned execution: out-of-core partitions and the lowered-plan
executor (counterpart of ``cudf_tpu/parallel/``; the distributed modules
wait for ROADMAP queue 1, distributed)."""

