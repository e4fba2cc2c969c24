"""Training: AdamW and the train loop (checkpoint, restore, resume)."""
