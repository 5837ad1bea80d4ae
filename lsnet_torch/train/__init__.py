"""Training: optimizer, schedule and the train step."""
