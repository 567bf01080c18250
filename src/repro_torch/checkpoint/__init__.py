"""Tree checkpoints (`checkpoint.py`)."""
