"""Multi-device paths over `torch.distributed`: the counterpart of
`pointclouds_tpu/parallel/`.

A 2-D ("frames", "points") `DeviceMesh` takes the place of the reference's
`jax.sharding.Mesh`; `comm.py` holds the collectives the reference's
`shard_map` bodies use (`lax.psum`, `all_gather`, `all_to_all`,
`ppermute`, ...) as functions on tensors over a process group.
`sharding.py` runs the batched pipelines with frames over the mesh,
`tiles.py` the spatial-tile points-axis design, `launch.py` spawns ranks
(the multi-device dry run).
"""
