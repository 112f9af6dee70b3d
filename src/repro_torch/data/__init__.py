"""The synthetic token pipeline of the LM stack (`pipeline`)."""
