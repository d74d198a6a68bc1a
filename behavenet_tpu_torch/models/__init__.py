"""Models of the port: architecture dicts, checkpoint io, the conv AE."""
