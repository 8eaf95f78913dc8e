"""Training: configs, train state, the CelebA step and the epoch loop."""
