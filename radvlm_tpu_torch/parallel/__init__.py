"""Multi-process layouts over `torch.distributed` (counterpart of
`radvlm_tpu/parallel/`): the mesh, tensor-parallel serving, ring attention
and sequence-parallel decode.

The JAX package is single-controller: one program traces a `shard_map` body
that runs on every device of a mesh. The port is SPMD: one process per rank,
each running the same engine loop over its own shard, with the collectives
the JAX body has (all_reduce, batch_isend_irecv, all_gather) and no others.
"""
