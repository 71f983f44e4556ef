"""Parallelism for the port (counterpart of ray_tpu/parallel): the device
mesh (mesh.py), logical-axis sharding rules and per-rank shards of a state
dict (sharding.py), and the collectives of a tensor-parallel rank (tp.py).

Ported so far: the serving half, tensor parallelism over a "tensor" axis.
Sharded training (data/fsdp axes), ring attention (ring.py), the pipeline
(pipeline.py) and expert parallelism are the next slice's."""
