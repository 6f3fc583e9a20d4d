"""Training substrate: data, AdamW, checkpoints, the train loop."""
