"""Training: the joint loss, the schedules, AdamW under OneCycle, and the
train step, loop and checkpoints."""
