"""Training: the optimizers, the train step, checkpoints and fault
tolerance (the counterpart of ``repro.train``)."""
