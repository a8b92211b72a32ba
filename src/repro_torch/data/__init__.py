"""The deterministic, restartable synthetic token stream (`pipeline`)."""
