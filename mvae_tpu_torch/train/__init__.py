"""Training of the port: the train and eval steps, the epoch driver and
its `.pth.tar` checkpoints."""
