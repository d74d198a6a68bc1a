"""Host-side data pipeline of the port: trial stores, transforms, prefetch."""
