"""Single-device counterparts of ``veles_tpu.parallel``: the dense
attention and MoE functions the decode path runs.  The mesh code (ring
attention, pipeline, expert sharding) is still to be ported."""
