"""Training engine: state, build, criterion, step, trainer, checkpoints."""
