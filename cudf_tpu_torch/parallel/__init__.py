"""Partitioned and distributed execution (counterpart of
``cudf_tpu/parallel/``): out-of-core partitions, the lowered-plan
executors, the mesh of shards (``spmd``), the multi-process bootstrap and
exchange (``multihost``, ``multiproc_stream``) and the streaming actor
graph (``actor_graph``)."""
