"""Training runtime of the port: optimizer and LR schedule
(`optimization`), train step, epoch loop and checkpoints (`trainer`)."""
