"""LM serving of the port: `engine.ServeEngine` (slot-based continuous
batching over `models.model.decode_step`)."""
