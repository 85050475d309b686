"""Moving serving state between meshes (port of ``repro.distributed``'s
``elastic`` module; the model-parameter sharding, collectives and gradient
compression belong to the training stack, ROADMAP queue 1 G)."""
