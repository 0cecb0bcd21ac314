"""Training substrate of the LM zoo: AdamW, the train step, the synthetic
data pipeline, checkpoints and fault tolerance (port of the JAX package's
``training/``)."""
