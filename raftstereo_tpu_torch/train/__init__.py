"""Training layer of the port: loss, optimizer, state, step, checkpoints
and the metrics logger."""
