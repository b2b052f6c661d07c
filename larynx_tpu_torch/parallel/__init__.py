"""Training steps and the multi-device layer: the serving mesh
(``mesh.ServingMesh``, ``serving_mesh``), the time and grid shards of the
vocode (``time_shard``), the sharded synthesis step (``serve``) and the
training mesh (``mesh.make_mesh``, the collectives of ``train``)."""
