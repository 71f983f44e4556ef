"""Expert parallelism: the switch-routed MoE layer (models/moe.py) over the
mesh's "expert" axis.

The reference shards the experts' leading dim over "expert"
(``LLAMA_SHARDING``'s ``("expert", "embed_fsdp", "mlp")`` rules) and the
batch over ("data", "fsdp") only, so every rank on an "expert" line holds
the same rows. Under XLA the expert einsums then run on the local experts
and the combine einsum ``bsec,bech->bsh`` sums over the sharded ``e``: a
sum over the expert group. The port does the same in each rank process,
with no all-to-all:

- the router is replicated: every rank computes the same softmax, argmax,
  capacity positions (C from the global E) and dispatch;
- the rank dispatches into its experts' buffers [B, E/n, C, H] only, runs
  them, and combines them into a partial output;
- the partial outputs are summed in float32 over the expert group
  (``ExpertParallel.all_reduce``), and the layer's input enters through
  ``copy_in``, so its gradient is summed over the group in backward.

Which experts a rank holds follows the sharding rules: E splits into
``size`` equal parts when ``size`` divides it and is replicated otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

from ray_tpu_torch.parallel.mesh import Mesh
from ray_tpu_torch.parallel.tp import AxisParallel


@dataclasses.dataclass(frozen=True)
class ExpertParallel(AxisParallel):
    axis: ClassVar[str] = "expert"


def expert_parallel(mesh: Optional[Mesh],
                    rank: int) -> Optional[ExpertParallel]:
    """The EP rank of mesh rank ``rank`` (None for no mesh or an "expert"
    axis of 1)."""
    if mesh is None or mesh.axis_size("expert") == 1:
        return None
    return ExpertParallel(mesh.axis_size("expert"),
                          mesh.coords(rank)["expert"], mesh)
