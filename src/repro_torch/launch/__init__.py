"""Train steps and the training driver."""
