"""Training: optimizer, schedules and the train step."""
