"""The actors' device paths on the port."""
