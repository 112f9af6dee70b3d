"""Sharding rules of the LM stack (`sharding`)."""
