"""Training (port of ``repro.train``): the data pipeline, AdamW, checkpoints
and the fault-tolerant loop."""
