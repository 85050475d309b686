"""Distributed pieces (port of ``repro.distributed``): the sharding rules
(``sharding``), the collective matmuls (``collectives``), gradient
compression (``compression``) and moving state between meshes
(``elastic``)."""
