"""Multi-device pieces of the port (twin of ``repro.distributed``): the
sharding rules and the placing of tensors on a named mesh (``sharding``),
compressed gradient sync and the in-process collectives (``collectives``),
GPipe over the pod axis (``pipeline_parallel``), checkpoints that restore
onto another mesh (``checkpoint``), elastic planning (``elastic``) and the
sequence-parallel top-k / sparse decode (``topk``). One process drives every
entry of a mesh, as one JAX program drives every device of its mesh."""
from repro_torch.distributed import (checkpoint, collectives, elastic,
                                     pipeline_parallel, sharding, topk)

__all__ = ["checkpoint", "collectives", "elastic", "pipeline_parallel",
           "sharding", "topk"]
