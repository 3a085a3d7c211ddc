"""The training step: optimizer and the Flare train step."""
