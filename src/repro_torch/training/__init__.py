"""AdamW (`adamw`), int8 error-feedback gradient compression
(`compression`) and the train step (`train_step`)."""
