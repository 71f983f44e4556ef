"""Parallelism for the port (counterpart of ray_tpu/parallel): the device
mesh and its per-axis process groups (mesh.py), logical-axis sharding rules
and per-rank shards of a state dict (sharding.py), the collectives of a
tensor-parallel rank with their gradient rules (tp.py), FSDP's gather and
reduce-scatter (fsdp.py) and the rank processes of a program over a whole
mesh (launch.py).

Ported so far: tensor-parallel serving and sharded training over "data",
"fsdp" and "tensor" axes. Ring attention (ring.py), the pipeline
(pipeline.py) and expert parallelism are later slices."""
