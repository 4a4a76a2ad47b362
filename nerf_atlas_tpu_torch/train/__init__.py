"""Training and eval driver, losses, optimizers and checkpoints."""
