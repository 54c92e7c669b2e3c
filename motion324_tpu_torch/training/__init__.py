"""Single-device training: loss, AdamW with the cosine schedule, the train
step, checkpoints and the host loop."""
