"""The port's copies of the plotting package's helpers (no plotting yet)."""
