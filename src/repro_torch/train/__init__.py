"""Training substrate. Ported so far: the optimizer (``train.optim``)."""
