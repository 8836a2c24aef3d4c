"""Multi-device runs over torch.distributed: the mesh and its collectives
(``mesh``) and event-axis sharding (``event_parallel``)."""
