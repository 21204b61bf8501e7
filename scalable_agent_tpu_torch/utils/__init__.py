"""Host utilities: timers and the JSONL metrics writer."""
