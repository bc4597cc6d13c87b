"""Training: the optimizer stack, the train/eval steps and the Trainer."""
