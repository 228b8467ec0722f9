"""Training: losses, Prodigy, LR schedulers and the train loop."""
