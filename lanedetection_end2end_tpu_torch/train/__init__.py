"""Training: optimizers, the train state and the e2e steps."""
