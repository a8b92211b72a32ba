"""Single-token decode over KV caches and recurrent states (`decode`)."""
