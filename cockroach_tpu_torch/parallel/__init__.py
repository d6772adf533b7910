"""The in-process SPMD plane: a mesh of shards, the hash shuffle, the
distributed operators and the plan lowering (port of
``cockroach_tpu.parallel``)."""
