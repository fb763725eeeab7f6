"""The yardstick's arithmetic: FLOPs, peaks and bounds, kernel groups."""
