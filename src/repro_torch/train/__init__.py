"""Training of the LM stack: the step builders (`step`) and the trainer
(`loop`)."""
