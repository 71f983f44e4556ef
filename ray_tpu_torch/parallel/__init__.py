"""Parallelism for the port (counterpart of ray_tpu/parallel): the device
mesh and its per-axis process groups (mesh.py), logical-axis sharding rules
and per-rank shards of a state dict (sharding.py), the collectives of a
rank along a model-parallel axis with their gradient rules (tp.py: tensor
parallelism; ep.py: expert parallelism over "expert"), FSDP's gather and
reduce-scatter (fsdp.py), ring attention over a "seq" axis with the
rotation ``ppermute`` (ring.py), GPipe microbatching over a "stage" axis
(pipeline.py) and the rank processes of a program over a whole mesh
(launch.py).

All of it is ported: serving over "tensor" and "expert" axes, and sharded
training over "data", "fsdp", "expert", "seq" and "tensor" axes."""
