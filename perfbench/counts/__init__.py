"""Model FLOPs and kernel bytes, worked out from shapes alone."""
