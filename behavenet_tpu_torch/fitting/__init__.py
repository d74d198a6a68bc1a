"""Training of the port: the trainer, experiment store, configs, CLIs."""
