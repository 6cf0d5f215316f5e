"""The fused period step (BASELINE config 5) on one device."""
