"""Many independent filters at once (multi-stream serving)."""
