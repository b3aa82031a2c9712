"""Training loop of the discrete model (`train.trainer`)."""
