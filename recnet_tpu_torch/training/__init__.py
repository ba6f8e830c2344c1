"""Training: the optimizer, the train and val steps, and the loop."""
