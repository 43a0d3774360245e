"""Training in the port: optimizers, the synthetic data stream, the train
step, checkpoints and the trainer (the reference's ``train/``)."""
