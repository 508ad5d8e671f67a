"""Pipeline parallelism of the port: the GPipe drivers over PIM partition
stage programs (``repro_torch.parallel.pipeline``). The reference's mesh
half — ``pipeline_forward`` / ``make_pipelined_fn`` over ``shard_map``
and the sharding rules — is not ported yet (ROADMAP.md, queue item 7)."""
