"""Training of the port: losses, shared utilities and the trainer CLIs."""
