"""Training: optimizer, train state and checkpoints, the step and the
epoch loop."""
