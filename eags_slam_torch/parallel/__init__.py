"""Multi-device mapping and tracking over `torch.distributed` (port of
eags_slam_tpu.parallel): `mesh.py` holds the mesh and the sharded steps,
`dryrun.py` the toy-scene run of every step."""
