"""Entry points: ``serve`` (carbon-aware batched serving)."""
