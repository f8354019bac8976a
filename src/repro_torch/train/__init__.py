"""Training substrate: optimizer, train steps, checkpointing, fault drills."""
